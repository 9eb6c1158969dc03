"""Zero-shot pathology classification, on one card or data-parallel.

Counterpart of ct_clip_ut_tpu/infer/zeroshot.py: the 36 prompts are
tokenised padded to 512 tokens and encoded once per checkpoint, each batch
of volumes is encoded once, and the [B, 36] similarity gives
softmax([present, absent]) per pathology. `CTClipInference.predict` is the
batch loop; `zeroshot` adds the metrics (`utils/metrics.py`, numpy only);
`infer` runs zero-shot and then, where asked, the attribution suite
(`attribution.suite.Visualizations` over `attribution_ctx`).

With a `mesh` (parallel.mesh.DataMesh) each rank scores its shard of the
dataset (its loader's ShardedSampler shard) and `gather_predictions`
brings every rank's predictions and labels together before the metrics
(the reference's gather_for_metrics). The sampler pads the last shard by
wrapping to the first samples; the gather puts the rows back in the
sampler's order and drops those wrapped duplicates, as gather_for_metrics
does (the JAX package's process_allgather keeps them, so they count twice
in its metrics). `zeroshot_probs_sharded` scores one global batch split
over the ranks.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..config import PATHOLOGIES
from ..models.ctclip import CTCLIP, encode_image_latents, encode_text_latents
from ..parallel import collectives
from ..parallel.mesh import check_mesh
from ..parallel.sharding import shard_loader
from ..utils import metrics


def prompt_texts(pathologies: Sequence[str] = PATHOLOGIES):
    """36 interleaved prompts: (present, absent) per pathology."""
    out = []
    for p in pathologies:
        out.append(f"There is {p}.")
        out.append(f"There is no {p}.")
    return out


def tokenize_prompts(tokenizer, pathologies: Sequence[str] = PATHOLOGIES,
                     max_length: int = 512, device="cuda") -> dict:
    """prompt_texts() through an HF-style tokenizer, padded to `max_length`
    (ct_clip_ut_tpu/infer/zeroshot.py:49-58), as int64 tensors on
    `device`: input_ids, attention_mask and, where the tokenizer gives
    them, token_type_ids."""
    device = _build.check_device(device)
    enc = tokenizer(prompt_texts(pathologies), return_tensors="np", padding="max_length",
                    truncation=True, max_length=max_length)
    keys = [k for k in ("input_ids", "attention_mask", "token_type_ids") if k in enc]
    return {k: torch.as_tensor(np.asarray(enc[k]), dtype=torch.int64, device=device)
            for k in keys}


class WordTokenizer:
    """A stand-in for an HF tokenizer where its files are absent (the
    repository holds none): one id per lower-cased word or punctuation
    mark, from a fixed hash into [1000, vocab_size), between [CLS] (101) and
    [SEP] (102), padded with 0. Called as tokenize_prompts and the T5
    conditioner call an HF tokenizer, it does what the call asks for (pad to
    max_length or to the longest text, truncate, numpy arrays; one text
    without return_tensors gives lists) and returns input_ids,
    attention_mask and token_type_ids. `convert_ids_to_tokens` maps the ids
    it has made back to their words, so keyword spans resolve. The prompts
    of prompt_texts() give 6 to 10 real tokens."""

    CLS, SEP, PAD = 101, 102, 0

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size
        self.words = {self.CLS: "[CLS]", self.SEP: "[SEP]", self.PAD: "[PAD]"}

    def word_id(self, word: str) -> int:
        h = 0
        for ch in word.encode():
            h = (h * 131 + ch) % 1_000_003
        i = 1000 + h % (self.vocab_size - 1000)
        self.words.setdefault(i, word)
        return i

    def __call__(self, texts, max_length: int = 512, padding="max_length",
                 truncation: bool = True, add_special_tokens: bool = True,
                 return_tensors=None, **hf_options) -> dict:
        rows = []
        for text in [texts] if isinstance(texts, str) else texts:
            words = text.lower().replace(".", " .").replace(",", " ,").split()
            row = [self.word_id(w) for w in words]
            if add_special_tokens:
                row = [self.CLS, *row, self.SEP]
            if truncation and len(row) > max_length:
                row = row[:max_length - 1] + [self.SEP] if add_special_tokens else row[:max_length]
            rows.append(row)
        if isinstance(texts, str) and return_tensors is None:
            return {"input_ids": rows[0], "attention_mask": [1] * len(rows[0]),
                    "token_type_ids": [0] * len(rows[0])}
        width = max_length if padding == "max_length" else max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.PAD, np.int64)
        mask = np.zeros_like(ids)
        for i, row in enumerate(rows):
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask, "token_type_ids": np.zeros_like(ids)}

    def convert_ids_to_tokens(self, ids) -> list:
        return [self.words.get(int(i), f"[{int(i)}]") for i in ids]


@torch.no_grad()
def encode_prompt_latents(model: CTCLIP, prompt_tokens: dict) -> torch.Tensor:
    """[2 * n_pathologies, dim_latent] fp32, computed once per checkpoint."""
    return encode_text_latents(model, prompt_tokens)


@torch.no_grad()
def zeroshot_probs(model: CTCLIP, image: torch.Tensor, prompt_latents: torch.Tensor,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   plain: bool = False) -> torch.Tensor:
    """[B, n_pathologies] positive-class probabilities of a [B, 1, T, H, W]
    batch. plain=True runs every kernel's plain version instead (the
    reference the card compares the kernel path with)."""
    img_lat, _ = encode_image_latents(model, image.to(compute_dtype), plain=plain)
    temp = model.temperature.exp()
    sim = (img_lat.float() @ prompt_latents.float().t()) * temp
    pair = torch.stack([sim[:, 0::2], sim[:, 1::2]], dim=-1)      # [B, 18, 2]
    return torch.softmax(pair, dim=-1)[..., 0]


@torch.no_grad()
def zeroshot_probs_sharded(model: CTCLIP, image, prompt_latents: torch.Tensor, mesh,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           plain: bool = False) -> torch.Tensor:
    """[B, n_pathologies] probabilities of one global [B, 1, T, H, W] batch
    that every rank holds, its rows split over the ranks
    (infer/zeroshot.py:96-150): a batch the data axis does not divide is
    padded by repeating its last row (rows score independently), each rank
    scores its rows, and the rows are gathered back, the padding dropped."""
    image = torch.as_tensor(image)
    b = image.shape[0]
    pad = (-b) % mesh.world
    if pad:
        image = torch.cat([image, image[-1:].expand(pad, *image.shape[1:])])
    per = image.shape[0] // mesh.world
    mine = image[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)
    probs = zeroshot_probs(model, mine, prompt_latents, compute_dtype, plain)
    return collectives.gather_rows(probs, mesh)[:b]


def gather_predictions(preds: np.ndarray, targets: np.ndarray, mesh, total: Optional[int] = None):
    """Every rank's (preds [n, k], targets [n, k]) on every rank (the
    reference's gather_for_metrics, CTClipInference.py:188); each rank
    holds the same number of rows. With `total`, the dataset's size under
    a ShardedSampler (its shard r holding padded positions r, r + world,
    ...), the rows come back in the sampler's order and the wrapped
    duplicates past `total` are dropped; without it they are concatenated
    rank by rank. A one-rank mesh returns its input."""
    if mesh is None or mesh.world == 1:
        return preds, targets
    out = []
    for a in (preds, targets):
        a = np.asarray(a, np.float64)
        g = collectives.gather_rows(torch.as_tensor(a, device=mesh.device), mesh).cpu().numpy()
        if total is not None:
            g = g.reshape(mesh.world, a.shape[0], -1).transpose(1, 0, 2).reshape(-1, a.shape[1])
            g = g[:total]
        out.append(g)
    return out[0].astype(np.asarray(preds).dtype), out[1].astype(np.asarray(targets).dtype)


class CTClipInference:
    """Zero-shot and attribution runner. `data` yields (images [B, 1, D, H,
    W], texts, labels [B, 18], ...); `prompt_tokens` is the tokenised
    prompt_texts() (`tokenize_prompts`: input_ids [36, 512] and
    attention_mask / token_type_ids) on the model's device. `visualize`
    ({method: True, or occlusion's keyword dict}) and `attribution_ctx` (an
    `attribution.suite.AttributionContext`) are what `infer` hands the
    suite (ct_clip_ut_tpu/infer/zeroshot.py:234-243). With a `mesh` the
    model lies on the mesh's device on every rank, each rank scores its
    shard of `data` (a loader with a one-shard ShardedSampler is given this
    rank's shard), the metrics are computed over the gathered predictions
    and rank 0 writes them."""

    def __init__(self, model: CTCLIP, prompt_tokens: dict, data: Iterable,
                 results_folder: str = "./results",
                 pathologies: Sequence[str] = PATHOLOGIES,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 mesh=None, zero_shot: bool = True, visualize: Optional[dict] = None,
                 attribution_ctx=None):
        if check_mesh(mesh) is not None:
            shard_loader(data, mesh)
        self.mesh = mesh
        self.model = model
        self.prompt_tokens = prompt_tokens
        self.data = data
        self.results_folder = Path(results_folder)
        self.pathologies = tuple(pathologies)
        self.compute_dtype = compute_dtype
        self.zero_shot = zero_shot
        self.visualize = visualize or {}
        self.attribution_ctx = attribution_ctx
        self.metrics_history = []
        self._prompt_latents: Optional[torch.Tensor] = None

    def prompt_latents(self) -> torch.Tensor:
        if self._prompt_latents is None:
            self._prompt_latents = encode_prompt_latents(self.model, self.prompt_tokens)
        return self._prompt_latents

    def predict(self):
        """(preds [N, 18], targets [N, 18]) as numpy. Batches are queued on
        the device without a host sync; the probabilities are fetched once
        at the end."""
        device = self.model.temperature.device
        latents = self.prompt_latents()
        preds, targets = [], []
        for images, _texts, labels, *_ in self.data:
            images = torch.as_tensor(images).to(device, non_blocking=True)
            preds.append(zeroshot_probs(self.model, images, latents, self.compute_dtype))
            targets.append(np.asarray(labels))
        return torch.cat(preds).float().cpu().numpy(), np.concatenate(targets, axis=0)

    def zeroshot(self):
        """predict(), then the metrics, appended to metrics_history and
        written to results_folder/metrics.txt (by rank 0 with a mesh, over
        every rank's predictions). Returns (metrics, preds, targets)."""
        preds, targets = self.predict()
        if self.mesh is not None:
            sampler = getattr(self.data, "sampler", None)
            preds, targets = gather_predictions(preds, targets, self.mesh,
                                                total=getattr(sampler, "n", None))
        m = metrics.calculate_metrics(preds, targets, list(self.pathologies))
        self.metrics_history.append(m)
        if self.mesh is None or self.mesh.is_main:
            metrics.save_metrics(self.metrics_history, list(self.pathologies),
                                 self.results_folder)
        return m, preds, targets

    def infer(self):
        """zeroshot() where zero_shot is set, then the attribution suite's
        flagged methods (the suite is kept as `self.suite`: its seconds a
        method); returns zeroshot()'s result or None."""
        start = time.time()
        result = self.zeroshot() if self.zero_shot else None
        if self.visualize and self.attribution_ctx is not None:
            from ..attribution.suite import Visualizations
            self.suite = Visualizations(self.attribution_ctx, self.results_folder)
            self.suite.visualize(**self.visualize)
        if self.mesh is None or self.mesh.is_main:
            print(f"Evaluation completed in {time.time() - start:.1f}s")
        return result
