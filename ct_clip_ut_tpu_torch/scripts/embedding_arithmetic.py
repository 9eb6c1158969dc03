"""Pathology diff embeddings from a labelled report corpus.

    python -m ct_clip_ut_tpu_torch.scripts.embedding_arithmetic \
        --reports reports.csv --labels labels.csv \
        [--checkpoint ctclip_state.pt] [--out resources/pathology_diff_embeddings.npy]

Counterpart of ct_clip_ut_tpu/scripts/embedding_arithmetic.py: the reports
and labels CSVs are joined on VolumeName (each reports row with the labels
rows of its volume, in the reports' order, as pandas' inner merge orders
them), each report is Findings_EN + Impressions_EN with a missing field
read as "" (pandas' NaN handling there), and `compute_diff_embeddings`
writes the pickled-dict .npy that occlusion's text-embeds mode reads
(`inference_ctclip --diff-embeds`). The CSVs are read with the `csv`
module, which the card's machine has (no pandas there).

Weights: --checkpoint, any of `convert.load_ctclip`'s three files (the
reference's ctclip_v2.pt, a port state dict, a port train-state
checkpoint); without it, random weights from --seed. --tokenizer DIR
tokenises the reports with the WordPiece tokenizer of DIR/vocab.txt;
without it, the stand-in `WordTokenizer`, which --checkpoint takes only
with --stand-in-tokenizer (`inference_ctclip.load_tokenizer`).
`main(argv, model_cfg=)` takes another configuration from Python.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import _build
from ..attribution.embedding_arithmetic import compute_diff_embeddings, save_diff_embeddings
from ..config import PATHOLOGIES, CTCLIPConfig, CTViTConfig
from ..data.datasets import read_csv_rows
from .inference_ctclip import load_model, load_tokenizer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reports", required=True, help="reports CSV")
    p.add_argument("--labels", required=True, help="labels CSV")
    p.add_argument("--checkpoint", default=None,
                   help="the reference's ctclip_v2.pt, a port state dict or a port train-state "
                        "checkpoint; default: random from --seed")
    p.add_argument("--out", default="resources/pathology_diff_embeddings.npy")
    p.add_argument("--tokenizer", default=None,
                   help="a directory holding the BERT tokenizer's vocab.txt; default: the "
                        "stand-in WordTokenizer")
    p.add_argument("--stand-in-tokenizer", action="store_true",
                   help="tokenise with the stand-in WordTokenizer although --checkpoint is given "
                        "(its ids mean nothing to trained weights)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def read_corpus(reports_csv, labels_csv, pathologies=PATHOLOGIES) -> tuple:
    """(texts, labels [len(texts), len(pathologies)] float, NaN where a
    label is missing) of the reports CSV joined with the labels CSV on
    VolumeName."""
    _, reports = read_csv_rows(reports_csv)
    _, label_rows = read_csv_rows(labels_csv)
    by_name = {}
    for row in label_rows:
        by_name.setdefault(row.get("VolumeName"), []).append(row)
    texts, labels = [], []
    for row in reports:
        for lab in by_name.get(row.get("VolumeName"), []):
            texts.append((row.get("Findings_EN") or "") + (row.get("Impressions_EN") or ""))
            labels.append([np.nan if lab.get(p) is None else float(lab[p]) for p in pathologies])
    return texts, np.asarray(labels, np.float64).reshape(len(texts), len(pathologies))


def main(argv=None, model_cfg: CTCLIPConfig = None) -> dict:
    """Returns the diff embeddings written to --out."""
    args = build_parser().parse_args(argv)
    device = _build.check_device(args.device)
    cfg = model_cfg or CTCLIPConfig(ctvit=CTViTConfig(dim_head=32))
    tokenizer = load_tokenizer(args, cfg.bert.vocab_size)
    model = load_model(cfg, args.checkpoint, args.seed, device)
    texts, labels = read_corpus(args.reports, args.labels)
    start = time.time()
    embeds = compute_diff_embeddings(model, tokenizer, texts, labels,
                                     batch_size=args.batch_size)
    save_diff_embeddings(embeds, args.out)
    print(f"saved {len(embeds)} pathology diff embeddings of {len(texts)} reports to {args.out} "
          f"in {time.time() - start:.1f}s")
    return embeds


if __name__ == "__main__":
    main()
