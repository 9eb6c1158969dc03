"""Pathology diff embeddings: report-embedding arithmetic.

Counterpart of ct_clip_ut_tpu/attribution/embedding_arithmetic.py (the
reference's embedding_arithmetic notebook): per pathology, the mean BERT
CLS embedding of the reports labelled 1 minus the mean over those labelled
0. Occlusion's text-embeds mode scores windows against these
(`occlusion.diff_embedding_latent`). The CLS embeddings come from
`bert_cls` in fp32, in batches padded to `max_length`: on the card the
fp32 bert_layer kernel at 512 tokens. The file format is the JAX
package's, a pickled dict in a .npy, so a file either package writes loads
in the other.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

from ..config import PATHOLOGIES
from ..models.bert import bert_cls
from ..models.ctclip import CTCLIP


@torch.no_grad()
def cls_embeddings(model: CTCLIP, tokenizer, reports: Sequence[str], batch_size: int = 32,
                   max_length: int = 512, plain: bool = False) -> np.ndarray:
    """[len(reports), dim_text] fp32 CLS embeddings, `batch_size` reports a
    forward, each padded to `max_length` tokens."""
    dev = model.temperature.device
    out = []
    for i in range(0, len(reports), batch_size):
        enc = tokenizer(list(reports[i:i + batch_size]), return_tensors="np",
                        padding="max_length", truncation=True, max_length=max_length)
        ids = torch.as_tensor(np.asarray(enc["input_ids"]), dtype=torch.int64, device=dev)
        mask = torch.as_tensor(np.asarray(enc["attention_mask"]), dtype=torch.int64, device=dev)
        tt = enc.get("token_type_ids")
        tt = torch.zeros_like(ids) if tt is None else torch.as_tensor(
            np.asarray(tt), dtype=torch.int64, device=dev)
        cls = bert_cls(model.text_transformer, ids, mask, tt, compute_dtype=torch.float32,
                       plain=plain)
        out.append(cls.float().cpu().numpy())
    return np.concatenate(out, axis=0)


def diff_embeddings(cls: np.ndarray, labels, pathologies: Sequence[str] = PATHOLOGIES
                    ) -> Dict[str, np.ndarray]:
    """pathology -> mean(cls[label 1]) - mean(cls[label 0]); a pathology
    without a positive or without a negative report is left out."""
    labels = np.asarray(labels)
    assert labels.shape == (len(cls), len(pathologies)), (labels.shape, len(cls))
    out = {}
    for j, pathology in enumerate(pathologies):
        pos, neg = labels[:, j] == 1, labels[:, j] == 0
        if pos.sum() == 0 or neg.sum() == 0:
            continue
        out[pathology] = cls[pos].mean(axis=0) - cls[neg].mean(axis=0)
    return out


def compute_diff_embeddings(model: CTCLIP, tokenizer, reports: Sequence[str], labels,
                            pathologies: Sequence[str] = PATHOLOGIES, batch_size: int = 32,
                            max_length: int = 512, plain: bool = False
                            ) -> Dict[str, np.ndarray]:
    """pathology -> [dim_text] diff embedding over a labelled corpus
    (labels [len(reports), len(pathologies)], 1 / 0, NaN for neither)."""
    labels = np.asarray(labels)
    assert labels.shape == (len(reports), len(pathologies)), labels.shape
    cls = cls_embeddings(model, tokenizer, reports, batch_size, max_length, plain)
    return diff_embeddings(cls, labels, pathologies)


def save_diff_embeddings(embeds: Dict[str, np.ndarray], path) -> None:
    """A pickled dict in a .npy (the reference resource's format)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.asarray(embeds, dtype=object), allow_pickle=True)


def load_diff_embeddings(path) -> Dict[str, np.ndarray]:
    """The dict a pathology_diff_embeddings.npy holds."""
    return np.load(path, allow_pickle=True).item()
