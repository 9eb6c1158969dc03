"""CT-CLIP contrastive training on one GPU or data-parallel.

    python -m ct_clip_ut_tpu_torch.scripts.train_ctclip \
        --data-train /data/train --data-valid /data/valid \
        --train-reports reports/train_reports.csv \
        --valid-reports reports/valid_reports.csv \
        --valid-labels labels/valid_labels.csv \
        --train-metadata metadata/train_metadata.csv \
        --valid-metadata metadata/valid_metadata.csv \
        --tokenizer CXR-BERT/ --checkpoint ctclip_v2.pt \
        --results-folder results/train/ctclip --batch-size 8 --grad-accum 4

    torchrun --nproc-per-node N -m ct_clip_ut_tpu_torch.scripts.train_ctclip ... --multihost

Counterpart of ct_clip_ut_tpu/scripts/train_ctclip.py, with its parser
flag for flag and its defaults, and --device (the card unless it says
cpu). It trains the flagship model (`CTCLIPConfig(ctvit=CTViTConfig(
dim_head=32))`, bf16 steps on 512-token reports) with `CTClipTrainer` over
`TrainDataset` (--data-train, its reports and metadata) and
`InferenceDataset` (--data-valid, with labels) through the threaded
`DataLoader`, shuffled by `ShardedSampler` from --seed. --grad-accum k
splits each batch into k microbatches under GradCache (the full batch's
InfoNCE objective; --batch-size must be a multiple of k).
--profile-steps N traces steps [2, 2 + N) of epoch 1 into --profile-dir.

--tokenizer DIR reads DIR/vocab.txt (CXR-BERT's, kept beside the
checkpoint) into the WordPiece tokenizer `data.tokenizer.BertWordPiece`
(nothing is downloaded: the default names a directory that must exist).
--checkpoint takes the reference's `ctclip_v2.pt`, a state dict of the
port's CTCLIP (`convert.load_ctclip`: the training starts from those
weights), or the port's train-state checkpoint (`last_checkpoint.pt`, or
with --sharded-checkpoints the directory `last_checkpoint.dcp`, of any
world size: the run resumes from it, moments, step and data position
included).

Data parallelism: --multihost (or --num-processes above 1) joins the
process group from torchrun's environment or from --coordinator-address /
--num-processes / --process-id, each rank on `cuda:LOCAL_RANK`; --mesh-data
is the data axis (every process by default). Each rank loads --batch-size
volumes a step; the similarity matrix is the global batch's. --fsdp
shards the parameters, gradients and Adam's moments over the ranks
(train/trainer.py); --sharded-checkpoints writes each checkpoint as a
directory every rank writes its pieces into, and FSDP over more than one
process needs it (as in JAX).

Refused with their ROADMAP items: --moe-experts above 0 (item 11h),
--mesh-model above 1 (item 11c). `main(argv, model_cfg=,
preprocess_cfg=)` takes another configuration from Python (the tests'
tiny one, the smoke's peg_pallas=True flagship).
"""

from __future__ import annotations

import argparse
import time

from .. import _build, convert
from ..config import CTCLIPConfig, CTViTConfig, PreprocessConfig, TrainConfig, replace
from ..data.datasets import InferenceDataset, TrainDataset
from ..data.loader import DataLoader, ShardedSampler
from ..data.tokenizer import BertWordPiece
from ..train import trainer as trainer_mod
from ..train.checkpoint import sharded_dir
from ..parallel.mesh import check_model_axis, make_cli_mesh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-train", required=True)
    p.add_argument("--data-valid", required=True)
    p.add_argument("--train-reports", required=True)
    p.add_argument("--valid-reports", required=True)
    p.add_argument("--valid-labels", required=True)
    p.add_argument("--train-metadata", required=True)
    p.add_argument("--valid-metadata", required=True)
    p.add_argument("--results-folder", default="./results/train/ctclip")
    p.add_argument("--checkpoint", default=None,
                   help="the reference's ctclip_v2.pt, a port state dict, or a port train-state "
                        "checkpoint to resume")
    p.add_argument("--tokenizer", default="microsoft/BiomedVLP-CXR-BERT-specialized",
                   help="a local directory holding the BERT tokenizer's vocab.txt")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--num-epochs", type=int, default=15)
    p.add_argument("--num-train-samples", type=int, default=5000)
    p.add_argument("--num-valid-samples", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1.25e-5)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--max-grad-norm", type=float, default=0.5)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="GradCache microbatch count: the full batch's InfoNCE objective at "
                        "batch/grad_accum activation memory (batch-size must be a multiple)")
    p.add_argument("--save-best-model", action="store_true")
    p.add_argument("--save-every-steps", type=int, default=0,
                   help="atomically write last_checkpoint every N steps (0 = off)")
    p.add_argument("--sharded-checkpoints", action="store_true",
                   help="checkpoints as directories every rank writes its pieces into "
                        "(torch.distributed.checkpoint); needed by --fsdp over processes")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--preprocess-cache", default=None,
                   help="dir for preprocessed-volume .npy cache")
    p.add_argument("--multihost", action="store_true",
                   help="join the torch.distributed process group (torchrun's environment, "
                        "or the three flags below)")
    p.add_argument("--coordinator-address", default=None, help="host:port of rank 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel mesh axis size (default: every process)")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="MoE CT-ViT experts: not ported above 0 (Queue 1 item 11h)")
    p.add_argument("--moe-aux-weight", type=float, default=0.01)
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel mesh axis size: not ported above 1 (Queue 1 item 11c)")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="trace steps [2, 2 + N) of epoch 1 with torch.profiler (0 = off)")
    p.add_argument("--profile-dir", default="/tmp/ctclip_trace")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear lr warmup steps (0 = constant lr)")
    p.add_argument("--decay-steps", type=int, default=0,
                   help="cosine lr decay steps after warmup (0 = none)")
    p.add_argument("--end-lr-frac", type=float, default=0.0,
                   help="cosine decay floor as a fraction of --lr")
    p.add_argument("--adam-mu-dtype", default=None,
                   help="dtype of Adam's first moment (e.g. bfloat16); default fp32")
    p.add_argument("--fsdp", action="store_true",
                   help="fully-sharded data parallelism: params, grads and Adam moments "
                        "sharded over the ranks at rest")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None, model_cfg: CTCLIPConfig = None,
         preprocess_cfg: PreprocessConfig = None) -> trainer_mod.CTClipTrainer:
    """Trains as the command line says; returns the trainer (its state,
    losses and results folder)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.grad_accum < 1 or args.batch_size % args.grad_accum:
        parser.error(f"--batch-size {args.batch_size} must be a positive multiple of "
                     f"--grad-accum {args.grad_accum}")
    cfg = model_cfg or CTCLIPConfig(ctvit=CTViTConfig(dim_head=32))
    cfg = replace(cfg, ctvit=replace(cfg.ctvit, moe_experts=args.moe_experts))
    train_cfg = TrainConfig(
        batch_size=args.batch_size, lr=args.lr, wd=args.wd, max_grad_norm=args.max_grad_norm,
        grad_accum=args.grad_accum, num_epochs=args.num_epochs,
        num_train_samples=args.num_train_samples, num_valid_samples=args.num_valid_samples,
        save_best_model=args.save_best_model, seed=args.seed,
        save_every_steps=args.save_every_steps, sharded_checkpoints=args.sharded_checkpoints,
        moe_aux_weight=args.moe_aux_weight, fsdp=args.fsdp, warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps, end_lr_frac=args.end_lr_frac,
        adam_mu_dtype=args.adam_mu_dtype, profile_steps=args.profile_steps,
        profile_dir=args.profile_dir)
    trainer_mod.check_supported(cfg, train_cfg)      # before any data or weights load
    check_model_axis(args.mesh_model)
    tokenizer = BertWordPiece.from_dir(args.tokenizer)
    mesh = make_cli_mesh(args)
    device = mesh.device if mesh is not None else _build.check_device(args.device)

    pre = preprocess_cfg or PreprocessConfig()
    train_ds = TrainDataset(args.data_train, args.train_reports, args.train_metadata,
                            num_samples=args.num_train_samples, preprocess_cfg=pre,
                            cache_dir=args.preprocess_cache)
    valid_ds = InferenceDataset(args.data_valid, args.valid_reports, args.valid_metadata,
                                args.valid_labels, num_samples=args.num_valid_samples,
                                preprocess_cfg=pre, cache_dir=args.preprocess_cache)
    # one shard each: the trainer gives every rank its own (CTClipTrainer)
    train_dl = DataLoader(train_ds, batch_size=args.batch_size,
                          sampler=ShardedSampler(len(train_ds), shuffle=True, seed=args.seed),
                          num_workers=args.num_workers)
    valid_dl = DataLoader(valid_ds, batch_size=args.batch_size,
                          sampler=ShardedSampler(len(valid_ds), shuffle=False),
                          num_workers=args.num_workers)

    params, resume = None, None
    if args.checkpoint and sharded_dir(args.checkpoint) is not None:
        resume = args.checkpoint        # a sharded train state, read by every rank below
    elif args.checkpoint:
        blob = convert.read_checkpoint(args.checkpoint)
        if convert.is_train_state(blob):
            resume = blob               # the port's train state, loaded whole below
        else:
            params = convert.ctclip_from(blob, cfg, device=device)
        del blob
    trainer = trainer_mod.CTClipTrainer(cfg, train_cfg, tokenizer, train_dl, valid_dl,
                                        results_folder=args.results_folder, params=params,
                                        mesh=mesh, device=device)
    if resume is not None:
        trainer.load_model(args.checkpoint, blob=None if isinstance(resume, str) else resume)
        del resume
    start = time.time()
    trainer.train()
    trainer.maybe_print(f"{int(trainer.state.step)} steps in {time.time() - start:.1f} s -> "
                        f"{trainer.results_folder}")
    return trainer


if __name__ == "__main__":
    main()
