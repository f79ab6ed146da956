#!/usr/bin/env python
"""One-time backbone conversion: an OpenAI CLIP .pt -> the .npz weight cache.

    python -m aa_clip_iqm_tpu_torch.tools.convert_backbone --pt ViT-L-14-336px.pt --img_size 518

Counterpart of the JAX package's ``tools/convert_backbone.py``, with its
flags: writes ``<pt-stem>.<img_size>.npz`` beside the input (``--out``
chooses another path), the positional embedding resized to the image
size's grid. The file has the JAX package's key layout, so either package's
loader reads it. ViT and ModifiedResNet (RN50) checkpoints both convert.
"""
import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pt", required=True, help="OpenAI .pt checkpoint")
    parser.add_argument("--model_name", default="ViT-L-14-336")
    parser.add_argument("--img_size", type=int, default=518)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    from ..configs import get_model_config
    from ..models.convert import load_openai_checkpoint, save_params_npz

    cfg = get_model_config(args.model_name, img_size=args.img_size)
    params = load_openai_checkpoint(args.pt, cfg)
    out = args.out or (os.path.splitext(args.pt)[0] + f".{args.img_size}.npz")
    save_params_npz(params, out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
