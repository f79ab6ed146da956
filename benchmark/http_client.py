#!/usr/bin/env python3
"""Open-loop HTTP client of the serving cell, standard library only, in a
process of its own (so that it shares no interpreter lock with the server).

It reads from standard input one JSON line (``port``, ``offsets``: each
request's due time in seconds from the start, ``bodies``: each request's
body index, ``keep``: the requests whose replies it returns, ``threads``,
``timeout``), then the bodies (a decimal count line, then per body a length
line and its bytes). It sends ``POST /v1/predict?map=npy`` with each body
at its due time, from a pool of worker threads on keep-alive connections,
and times each request from its due time to the last byte of its reply. It
writes one JSON object to standard output: per request ``[status,
seconds late, latency seconds]`` (status 0 and latency null for a request
that failed), and the kept replies' bodies.
"""
import http.client
import json
import queue
import sys
import threading
import time


def read_bodies(stream):
    n = int(stream.readline())
    bodies = []
    for _ in range(n):
        size = int(stream.readline())
        bodies.append(stream.read(size))
    return bodies


def main():
    stdin = sys.stdin.buffer
    spec = json.loads(stdin.readline())
    bodies = read_bodies(stdin)
    offsets, which, keep = spec["offsets"], spec["bodies"], set(spec["keep"])
    results = [None] * len(offsets)
    kept = {}
    work = queue.Queue()
    t0 = time.perf_counter() + 0.5

    def worker():
        conn = None
        while True:
            i = work.get()
            if i is None:
                return
            due = t0 + offsets[i]
            late = time.perf_counter() - due
            try:
                if conn is None:
                    conn = http.client.HTTPConnection("127.0.0.1", spec["port"],
                                                      timeout=spec["timeout"])
                conn.request("POST", "/v1/predict?map=npy", body=bodies[which[i]],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                done = time.perf_counter()
                status = resp.status
                if resp.getheader("Connection", "").lower() == "close":
                    conn.close()
                    conn = None
            except (OSError, http.client.HTTPException):
                if conn is not None:
                    conn.close()
                conn = None
                results[i] = [0, late, None]
                continue
            results[i] = [status, late, done - due if status == 200 else None]
            if i in keep:
                kept[i] = data.decode()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(spec["threads"])]
    for t in threads:
        t.start()
    for i, off in enumerate(offsets):
        wait = t0 + off - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        work.put(i)
    for _ in threads:
        work.put(None)
    for t in threads:
        t.join()
    json.dump({"results": results, "kept": kept, "start": t0}, sys.stdout)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
