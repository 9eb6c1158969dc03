"""CT-CLIP zero-shot evaluation and attribution, on one GPU or data-parallel.

    python -m ct_clip_ut_tpu_torch.scripts.inference_ctclip \
        --data-valid /data/valid --valid-reports reports/valid_reports.csv \
        --valid-labels labels/valid_labels.csv \
        --valid-metadata metadata/valid_metadata.csv --zero-shot [--quantize-ff] \
        [--visualize occlusion grad_cam ...] [--diff-embeds D.npy --occlusion-text-embeds]

    torchrun --nproc-per-node N -m ct_clip_ut_tpu_torch.scripts.inference_ctclip \
        ... --multihost [--mesh-data N]

Counterpart of ct_clip_ut_tpu/scripts/inference_ctclip.py, with its parser
flag for flag and its refusals (--quantize-ff with a gradient method,
--occlusion-text-embeds without occlusion or --diff-embeds). --zero-shot
reads the .nii.gz volumes under --data-valid through `InferenceDataset`
(the reports, labels and metadata CSVs) and the threaded `DataLoader`,
scores them with `CTClipInference.zeroshot()` (36 prompts padded to 512
tokens, bf16 volumes) and writes metrics.txt to --results-folder.
--quantize-ff serves the visual transformer's FFs W8A8 (`quantize_ctclip_ff`,
the geglu_ff_int8 kernel: bf16 activations for zero-shot, fp32 under the
forward attribution methods, raw attention, rollout and occlusion, which
it pairs with as in the JAX script). --visualize runs the attribution suite
(`attribution.suite.Visualizations` through `CTClipInference.infer()`)
over the same dataset, one volume at a time, writing each method's maps
and GIFs under --results-folder; --diff-embeds loads the diff embeddings
(`scripts.embedding_arithmetic`) that --occlusion-text-embeds scores
against, and --occlusion-prompt tags occlusion's file names. Without
matplotlib or pillow, --visualize raises before the model loads;
--no-gifs (the port's own flag: the JAX script always renders) writes the
maps alone and needs neither.

Data parallelism: --multihost (or --num-processes above 1) joins the
process group, from torchrun's environment or from --coordinator-address /
--num-processes / --process-id (parallel.mesh.initialize_runtime: NCCL for
CUDA ranks, gloo for --device cpu), each rank on `cuda:LOCAL_RANK`.
--mesh-data N (the group's size by default) is the data axis: each rank
scores its shard of the volumes, rank 0 writes metrics.txt over all of
them (wrapped duplicates of the last shard dropped), occlusion sweeps its
windows and integrated gradients each map's steps over the ranks, rank 0
writing every map (the suite, attribution/suite.py).
--mesh-model above 1, the tensor-parallel axis, raises (Queue 1 item 11c).

Weights: --checkpoint, the reference's ctclip_v2.pt, a state dict of the
port's CTCLIP or the port's train-state checkpoint (`convert.load_ctclip`);
without it, random weights from --seed. --tokenizer DIR tokenises the
prompts with the WordPiece tokenizer of DIR/vocab.txt
(`data.tokenizer.BertWordPiece`, CXR-BERT's vocabulary where the weights
are the reference's); without it, the stand-in `WordTokenizer`, whose ids
mean nothing to trained weights: with --checkpoint it raises unless
--stand-in-tokenizer (the port's own flag) asks for it.
`main(argv, model_cfg=, preprocess_cfg=)` takes another configuration from
Python (the tests' tiny one); the command line serves the JAX script's
`CTCLIPConfig(ctvit=CTViTConfig(dim_head=32))`.
"""

from __future__ import annotations

import argparse

import torch

from .. import _build, convert
from ..attribution.embedding_arithmetic import load_diff_embeddings
from ..attribution.suite import AttributionContext
from ..config import CTCLIPConfig, CTViTConfig, PreprocessConfig
from ..data.datasets import InferenceDataset
from ..data.loader import DataLoader, ShardedSampler
from ..data.tokenizer import BertWordPiece
from ..infer.zeroshot import CTClipInference, WordTokenizer, tokenize_prompts
from ..models.ctclip import CTCLIP, init_ctclip
from ..ops.quant import quantize_ctclip_ff
from ..parallel.mesh import make_cli_mesh
from ..utils import visualizations


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-valid", required=True)
    p.add_argument("--valid-reports", required=True)
    p.add_argument("--valid-labels", required=True)
    p.add_argument("--valid-metadata", required=True)
    p.add_argument("--results-folder", default="./results/valid/ctclip")
    p.add_argument("--diff-embeds", default=None,
                   help="pathology_diff_embeddings.npy for occlusion's text-embeds mode")
    p.add_argument("--checkpoint", default=None,
                   help="the reference's ctclip_v2.pt, a port state dict or a port train-state "
                        "checkpoint; default: random from --seed")
    p.add_argument("--tokenizer", default=None,
                   help="a directory holding the BERT tokenizer's vocab.txt; default: the "
                        "stand-in WordTokenizer")
    p.add_argument("--stand-in-tokenizer", action="store_true",
                   help="tokenise with the stand-in WordTokenizer although --checkpoint is given "
                        "(its ids mean nothing to trained weights)")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--num-valid-samples", type=int, default=10)
    p.add_argument("--preprocess-cache", default=None,
                   help="dir for preprocessed-volume .npy cache")
    p.add_argument("--zero-shot", action="store_true")
    p.add_argument("--visualize", nargs="*", default=[],
                   choices=["raw_attention_maps", "attention_rollout",
                            "integrated_gradients", "grad_cam", "occlusion"],
                   help="attribution methods to run over the dataset (fp32)")
    p.add_argument("--no-gifs", action="store_true",
                   help="--visualize writes the .npy maps alone, no GIFs (no matplotlib needed)")
    p.add_argument("--occlusion-text-embeds", action="store_true",
                   help="occlusion in the diff-embedding bypass mode (requires --diff-embeds)")
    p.add_argument("--multihost", action="store_true",
                   help="join the torch.distributed process group (torchrun's environment, "
                        "or the three flags below) before anything touches the card")
    p.add_argument("--coordinator-address", default=None, help="host:port of rank 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel mesh axis size (default: every process)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel mesh axis size: not ported above 1 (Queue 1 item 11c)")
    p.add_argument("--occlusion-prompt", default="",
                   help="tag recorded in occlusion artifact filenames")
    p.add_argument("--quantize-ff", action="store_true",
                   help="serve the visual transformer's GEGLU FFs W8A8 (the geglu_ff_int8 "
                        "kernel, bf16 or fp32 activations; forward-only, so incompatible with "
                        "gradient-based attribution)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def load_model(cfg: CTCLIPConfig, checkpoint, seed: int, device) -> CTCLIP:
    """The port's CTCLIP from `checkpoint` (any of convert.load_ctclip's
    three files), or seeded random weights."""
    if checkpoint is None:
        return init_ctclip(cfg, seed=seed, device=device)
    return convert.load_ctclip(checkpoint, cfg, device=device)


def load_tokenizer(args, vocab_size: int):
    """The WordPiece tokenizer of --tokenizer DIR/vocab.txt, or without it
    the stand-in WordTokenizer, which weights from --checkpoint take only
    with --stand-in-tokenizer."""
    if args.tokenizer is not None:
        return BertWordPiece.from_dir(args.tokenizer)
    if args.checkpoint is not None and not args.stand_in_tokenizer:
        raise ValueError("--checkpoint's weights read the ids of the tokenizer they were trained "
                         "with: pass --tokenizer DIR (its vocab.txt; CXR-BERT's for the "
                         "reference's weights), or --stand-in-tokenizer to score with the "
                         "stand-in WordTokenizer's ids all the same")
    return WordTokenizer(vocab_size)


def main(argv=None, model_cfg: CTCLIPConfig = None, preprocess_cfg: PreprocessConfig = None):
    """Returns (metrics, preds, targets) of --zero-shot, else None."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.occlusion_text_embeds:
        if "occlusion" not in args.visualize:
            parser.error("--occlusion-text-embeds requires --visualize occlusion")
        if not args.diff_embeds:
            parser.error("--occlusion-text-embeds requires --diff-embeds")
    if args.quantize_ff:
        grad_methods = {"integrated_gradients", "grad_cam"} & set(args.visualize)
        if grad_methods:
            parser.error("--quantize-ff is forward-only (the int8 kernel raises under "
                         "autograd); drop " + ", ".join(sorted(grad_methods)))
    if args.visualize and not args.no_gifs:
        visualizations.require_renderer()   # before the model loads

    mesh = make_cli_mesh(args)
    device = mesh.device if mesh is not None else _build.check_device(args.device)
    cfg = model_cfg or CTCLIPConfig(ctvit=CTViTConfig(dim_head=32))
    tokenizer = load_tokenizer(args, cfg.bert.vocab_size)
    model = load_model(cfg, args.checkpoint, args.seed, device)
    if args.quantize_ff:
        model = quantize_ctclip_ff(model)
    ds = InferenceDataset(args.data_valid, args.valid_reports, args.valid_metadata,
                          args.valid_labels, num_samples=args.num_valid_samples,
                          preprocess_cfg=preprocess_cfg or PreprocessConfig(),
                          cache_dir=args.preprocess_cache)
    # each rank's interleaved shard (the reference's DistributedSampler,
    # CTClipInference.py:59); one process takes the whole dataset
    world, rank = (mesh.world, mesh.rank) if mesh is not None else (1, 0)
    dl = DataLoader(ds, batch_size=args.batch_size,
                    sampler=ShardedSampler(len(ds), shuffle=False, drop_last=False,
                                           num_shards=world, shard_index=rank),
                    num_workers=args.num_workers, drop_last=False)
    prompts = tokenize_prompts(tokenizer, device=device)
    visualize = {name: True for name in args.visualize}
    if "occlusion" in visualize and (args.occlusion_text_embeds or args.occlusion_prompt):
        visualize["occlusion"] = {"use_text_embeds": args.occlusion_text_embeds,
                                  "prompt": args.occlusion_prompt}
    ctx = AttributionContext(model=model, tokenizer=tokenizer, data=ds,
                             diff_embeds=(load_diff_embeddings(args.diff_embeds)
                                          if args.diff_embeds else None),
                             render_gifs=not args.no_gifs, mesh=mesh)
    inference = CTClipInference(model, prompts, dl, results_folder=args.results_folder,
                                zero_shot=args.zero_shot, visualize=visualize,
                                attribution_ctx=ctx, mesh=mesh)
    result = inference.infer()
    if result is not None and (mesh is None or mesh.is_main):
        print(f"zero-shot: {len(ds)} volumes, mean ROC-AUC {result[0]['mean_roc_auc']:.4f} -> "
              f"{inference.results_folder / 'metrics.txt'}")
    return result


if __name__ == "__main__":
    main()
