"""Convert the reference's torch checkpoints into state dicts of the port.

    python -m ct_clip_ut_tpu_torch.scripts.convert_checkpoint \
        --kind ctclip --in ctclip_v2.pt --out ctclip_v2_port.pt
    python -m ct_clip_ut_tpu_torch.scripts.convert_checkpoint \
        --kind ctgenerate --in ctgenerate_filtered.pt --t5 t5_encoder.pt --out ctgenerate_port.pt

Counterpart of ct_clip_ut_tpu/scripts/convert_checkpoint.py. `ctclip_v2.pt`
(the reference's CTCLIP state dict, as its trainer saves it or bare) goes
through `convert.reference_ctclip_state`; `ctgenerate_filtered.pt` (its
CT-ViT and MaskGit) with --t5, a local state-dict file of an HF
`T5EncoderModel` (`torch.save(T5EncoderModel.from_pretrained(...)
.state_dict())` where transformers and the weights are at hand), through
`convert.reference_ctgenerate_state`. Nothing is downloaded: without --t5 a
CTGenerate conversion raises naming the missing file. An unknown or a
missing key raises naming it (`convert.REFERENCE_DROPPED` lists the
reference's keys the port has no place for). The output is a state dict
of the port's module (`torch.save(model.state_dict())`'s layout), which
every CLI's --checkpoint loads; the conversion runs on the host, no card
needed. `main(argv, model_cfg=)` takes another configuration from Python.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from .. import convert
from ..config import CTCLIPConfig, CTGenerateConfig, CTViTConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kind", choices=["ctclip", "ctgenerate"], required=True)
    p.add_argument("--in", dest="inp", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--t5", default=None,
                   help="a local state-dict file of an HF T5EncoderModel: CTGenerate's text tower")
    return p


def main(argv=None, model_cfg=None) -> dict:
    """Writes --out; returns the port's state dict."""
    args = build_parser().parse_args(argv)
    blob = convert.read_checkpoint(args.inp)
    if args.kind == "ctclip":
        sd = convert.reference_ctclip_state(blob, model_cfg or CTCLIPConfig(
            ctvit=CTViTConfig(dim_head=32)))
    else:
        if args.t5 is None or not Path(args.t5).is_file():
            raise FileNotFoundError(
                f"the T5 tower's state-dict file {args.t5 or '(--t5 not given)'} is missing: "
                "the reference's CTGenerate checkpoint holds no T5 weights")
        sd = convert.reference_ctgenerate_state(blob, model_cfg or CTGenerateConfig(),
                                                convert.read_checkpoint(args.t5))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    torch.save(sd, args.out)
    print(f"wrote {args.out}: {len(sd)} tensors of the port's {args.kind}")
    return sd


if __name__ == "__main__":
    main()
