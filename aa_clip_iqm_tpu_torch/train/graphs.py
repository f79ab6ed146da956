"""The training and evaluation programs as CUDA graphs.

Counterpart of the ``jax.jit`` wrappers of ``aa_clip_iqm_tpu/train/steps.py``
(and of the jitted predict of ``evaluation/predict.py``): where the JAX
package compiles a program once per input shape, the port captures it as a
CUDA graph once per shape key and replays it on static buffers, so that a
step or a batch costs one launch from the host instead of thousands.

- :class:`GraphedStep` replays a training step (``steps.make_stage1_step``,
  ``steps.make_stage2_step``): forward, backward (the backward kernels
  launch from autograd's device thread onto the capturing stream) and the
  optimizer's update, all in the graph. The optimizer must be graphable
  (``optim``: tensor learning rates, ``capturable`` step counters); the
  schedule advances after each replay, outside the graph.
- :class:`GraphedFn` replays a program without state: the stage-1 feature
  program and ``evaluate_dataset``'s predict calls. Its outputs are the
  graph's static tensors, which the next call overwrites.
- :class:`GraphCache` holds the memory pool that a run's graphs share and
  the programs by name, so that a caller that runs a program again (a
  benchmark's repeated sweeps) replays what it captured.

The programs run as graphs where :func:`enabled` says so: on a CUDA device,
unless NaN checks are on (``utils.profiling.enable_nan_checks`` must see
every op), and under a data- or tensor-parallel mesh only where its process
group's collectives can be captured. NCCL's can: a captured step holds its
gradient all-reduce and replays it. gloo's cannot (its collectives run on
the host, outside any stream), so on a gloo process group the programs run
eagerly; that is a rule of the backend, not a fallback. Elsewhere, and on
the CPU, the callers run the eager functions. A capture that fails raises:
nothing falls back to the eager program.

A step is the span ``aaclip/step`` (``utils.profiling.span``) with the
children ``step/prepare`` (kept-token draw, key and held check, gradients
pointed back; a capture, span ``capture``, falls inside), ``step/copy_in``,
``step/replay`` and ``step/advance`` (schedule, loss copy); the counters are
``step.calls``, ``graphs.captures`` and ``graphs.capture_s``.

The anchors program (``prompts.compute_frozen_anchors``) runs once per run
and the per-class metric program each shape once per class: a graph of
either would never be replayed, so both stay eager.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, List

import torch

from ..models import clip as clip_mod
from ..models.convert import tree_leaves
from ..ops import interp
from ..utils.profiling import count, nan_checks_enabled, span


def enabled(device, mesh=None) -> bool:
    """Whether programs on ``device`` (under ``mesh``, a
    ``parallel.mesh.Mesh``, if given) run as CUDA graphs."""
    return (torch.device(device).type == "cuda" and not nan_checks_enabled()
            and (mesh is None or mesh.graphable))


def capture(fn: Callable, pool, device):
    """Warm ``fn`` up once on a side stream, then capture one call of it into
    a new CUDA graph whose intermediates live in ``pool``. Returns (the
    graph, what the captured call returned: static tensors that every replay
    rewrites).

    The warm-up does what must not happen inside a capture: the kernels'
    first launches (library loads, shared-memory attributes), the device
    constants, the optimizer's lazily made state. ``capture_error_mode=
    "thread_local"`` confines the capture's ban on unsafe CUDA calls to the
    calling thread: a data-prefetch or checkpoint-writing thread may go on
    with its own work. Kernels that autograd's device thread launches onto
    the capturing stream (the backward's) are captured all the same. The TMA
    tensor maps are encoded with the addresses of the capture's launch, which
    holds because the inputs, the weights and the pool's intermediates never
    move while the graph lives."""
    device = torch.device(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # Python's cycle collector must not run inside the capture: a dead graph
    # it destroyed there would release its memory pool, which frees device
    # memory, and that invalidates the capture (a later call then fails with
    # "operation failed due to a previous error during capture").
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            out = fn()
    finally:
        if enabled:
            gc.enable()
    return graph, out


def pool_memory(pool) -> int:
    """Bytes of device memory in the segments of a graph memory pool."""
    if pool is None:
        return 0
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


@contextlib.contextmanager
def state_restored(params, opt_state=None):
    """Undo on exit what the code inside did to ``params`` and to the state
    of ``opt_state``'s optimizer: the tensors are copied back in place, and
    state entries made inside are zeroed (a fresh Adam state is zeros), so
    that they stay the tensors a graph captured. For a warm-up before a
    capture, and for a step run only to be measured."""
    leaves = list(tree_leaves(params))
    saved = [t.detach().clone() for t in leaves]
    state = {} if opt_state is None else opt_state.optimizer.state
    before = {(p, k): v.detach().clone() for p, st in state.items() for k, v in st.items()}
    try:
        yield
    finally:
        with torch.no_grad():
            for t, s in zip(leaves, saved):
                t.copy_(s)
            for p, st in state.items():
                for k, v in st.items():
                    old = before.get((p, k))
                    v.copy_(old) if old is not None else v.zero_()


def _flatten(args) -> list:
    """The tensors of ``args`` (tensors, lists of tensors and None) in order."""
    out = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out.extend(a)
        elif a is not None:
            out.append(a)
    return out


def _unflatten(args, flat: list) -> list:
    """``args`` with its tensors replaced, in order, by those of ``flat``."""
    it = iter(flat)
    return [[next(it) for _ in a] if isinstance(a, (list, tuple))
            else (None if a is None else next(it)) for a in args]


def _key(args) -> tuple:
    """A capture's key: the structure, shapes and dtypes of ``args``, and
    the attention route that ``models.clip.FUSED_ATTN`` picks."""
    parts = []
    for a in args:
        if isinstance(a, (list, tuple)):
            parts.append(tuple((tuple(t.shape), t.dtype) for t in a))
        elif a is None:
            parts.append(None)
        else:
            parts.append((tuple(a.shape), a.dtype))
    return tuple(parts) + (clip_mod.FUSED_ATTN,)


class _Capture:
    """One captured graph: its static inputs and outputs, the objects it was
    captured on (kept alive, and compared at each call), the gradients its
    backward owns, the device constants its program reads (kept alive), its
    replays, capture seconds and pool growth, and ``run``: the eager program
    on the graph's own buffers and objects, which a replay is held to."""

    def __init__(self, graph, run, inputs, outputs, held, version, capture_s,
                 pool_bytes, grads=None, constants=None):
        self.graph, self.run = graph, run
        self.inputs, self.outputs = inputs, outputs
        self.held, self.version = held, version
        self.grads, self.constants = grads, constants
        self.capture_s, self.pool_bytes, self.replays = capture_s, pool_bytes, 0

    def holds(self, held, version=None) -> bool:
        return version == self.version and len(held) == len(self.held) and all(
            a is b for a, b in zip(held, self.held))


class GraphCache:
    """The CUDA graph memory pool that a run's captured programs share, the
    programs by name, and their live captures (a recapture replaces the
    stale one). Graphs that share a pool reuse each other's intermediates,
    so they must not replay at the same time: the programs of one cache run
    on one thread."""

    def __init__(self):
        self._pool = None
        self._programs: Dict[object, object] = {}
        self.captures: List[_Capture] = []

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def program(self, name, make: Callable):
        """The program registered under ``name`` (hashable), made by
        ``make()`` at the first request."""
        prog = self._programs.get(name)
        if prog is None:
            prog = self._programs[name] = make()
        return prog

    def memory(self) -> int:
        """Bytes of device memory the pool holds."""
        return pool_memory(self._pool)

    def _capture(self, fn, held, inputs, device, version=None, grads_of=None,
                 replaces=None):
        if replaces is not None:
            self.captures.remove(replaces)
        t0 = time.perf_counter()
        with span("capture"):
            pool0 = self.memory()
            graph, outputs = capture(fn, self.pool(), device)
            torch.cuda.synchronize(device)
            grads = None if grads_of is None else [t.grad for t in grads_of]
            capture_s = time.perf_counter() - t0
            count("graphs.captures")
            count("graphs.capture_s", capture_s)
            cap = _Capture(graph, fn, inputs, outputs, held, version, capture_s,
                           self.memory() - pool0, grads=grads,
                           constants=interp.device_constants())
            self.captures.append(cap)
            return cap


def _static_copy(x: torch.Tensor, device) -> torch.Tensor:
    """A fresh device buffer holding ``x``."""
    return x.detach().to(device, copy=True)


class GraphedFn:
    """``fn(*args)`` as CUDA graphs, one per key of its tensor arguments;
    dict arguments (weight trees) are held: a graph is captured on those
    objects and recaptured when a call passes others. Returns the graph's
    static outputs, valid until the next call."""

    def __init__(self, fn: Callable, cache: GraphCache, name: str = "program"):
        self.fn, self.cache, self.name = fn, cache, name
        self.graphs: Dict[tuple, _Capture] = {}

    def __call__(self, *args):
        held = tuple(a for a in args if isinstance(a, dict))
        data = [a for a in args if not isinstance(a, dict)]
        key = _key(data)
        g = self.graphs.get(key)
        if g is None or not g.holds(held):
            device = _flatten(data)[0].device
            inputs = [_static_copy(t, device) for t in _flatten(data)]
            static = iter(_unflatten(data, inputs))
            call = [a if isinstance(a, dict) else next(static) for a in args]
            fn = self.fn    # not self: a capture must not hold its owner

            def run():
                return fn(*call)

            g = self.graphs[key] = self.cache._capture(run, held, inputs, device,
                                                       replaces=g)
        else:
            for dst, src in zip(g.inputs, _flatten(data)):
                dst.copy_(src)
        g.graph.replay()
        g.replays += 1
        return g.outputs


class GraphedStep:
    """A training step replayed as CUDA graphs, with the eager step's
    signature and results: ``step(params, opt_state, frozen, *batch) ->
    (params, opt_state, loss)``, for the steps of ``train/steps.py``.

    One graph per key: the batch's shapes and dtypes and ``FUSED_ATTN`` (the
    step's ``grad_accum_steps`` and clipping are its own). A key is captured
    at its first call, after a warm-up step whose effects on the parameters
    and the optimizer are undone (:func:`state_restored`), so that a run
    takes exactly the steps it takes eagerly. It is captured again when a
    call passes other parameter tensors, another optimizer, an optimizer
    whose state was loaded since (``OptState.version``: a load replaces the
    state tensors) or another frozen tree. The batch's tensors are copied
    into the graph's static buffers, from the host or the device. A
    patch-dropout generator is drawn outside the graph
    (``step.keep_indices``), from the same generator in the eager step's
    order, and the indices copied in. The graph's backward owns the
    gradients: they are pointed back at before each replay, so ``.grad``
    reads the last step's gradients as after an eager step. The schedule
    advances after the replay; the returned loss is a copy of the static
    one."""

    def __init__(self, step: Callable, cache: GraphCache, name: str = "step"):
        self.step, self.cache, self.name = step, cache, name
        self.graphs: Dict[tuple, _Capture] = {}

    def __call__(self, params, opt_state, frozen, *batch):
        if not opt_state.graphable:
            raise ValueError("a captured step needs a graphable optimizer "
                             "(optim.stage1_optimizer / stage2_optimizer on the card)")
        count("step.calls")
        with span("step"):
            with span("step/prepare"):
                batch = list(batch)
                if isinstance(batch[-1], torch.Generator):
                    images = batch[0]
                    batch[-1] = self.step.keep_indices(batch[-1], images.shape[0],
                                                       images.device)
                leaves = list(tree_leaves(params))
                held = (*leaves, opt_state, frozen)
                key = _key(batch)
                g = self.graphs.get(key)
                fresh = g is None or not g.holds(held, opt_state.version)
                if fresh:
                    g = self.graphs[key] = self._capture(params, opt_state, frozen, batch,
                                                         leaves, held, replaces=g)
                for t, grad in zip(leaves, g.grads):
                    t.grad = grad
            if not fresh:
                with span("step/copy_in"):
                    for dst, src in zip(g.inputs, _flatten(batch)):
                        dst.copy_(src)
            with span("step/replay"):
                g.graph.replay()
            g.replays += 1
            with span("step/advance"):
                opt_state.advance()
                return params, opt_state, g.outputs.clone()

    def _capture(self, params, opt_state, frozen, batch, leaves, held, replaces):
        device = leaves[0].device
        inputs = [_static_copy(t, device) for t in _flatten(batch)]
        static = _unflatten(batch, inputs)
        update = self.step.update   # not self: a capture must not hold its owner

        def run():
            return update(params, opt_state, frozen, *static)

        with state_restored(params, opt_state):
            return self.cache._capture(run, held, inputs, device,
                                       version=opt_state.version, grads_of=leaves,
                                       replaces=replaces)
