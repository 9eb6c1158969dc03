"""Datasets: CT-RATE-style directory walk + reports/labels/metadata CSV join.

Counterpart of ct_clip_ut_tpu/data/datasets.py (reference
src/utils/TrainDataset.py and src/utils/InferenceDataset.py), with the
JAX package's two fixes of reference defects (SURVEY.md 2.5 #3, #7): the
train path calls the preprocessor with its model_type, and missing report
fields become "" instead of the string "nan".

The CSVs are read with the `csv` module (the card's machine has no
pandas), keeping what pandas.read_csv does by default to the fields these
classes read: a field in pandas' default missing-value set (the empty
field, "NA", "NaN", "null", ...) is missing, so a missing report field
reads "" and a missing label NaN; blank lines are skipped; a repeated
VolumeName keeps its last reports and labels row and its first metadata
row, as the JAX package's lookups do.
"""

from __future__ import annotations

import csv
import hashlib
import os
from typing import List, Optional, Tuple

import numpy as np

from ..config import PreprocessConfig
from .preprocess import process_file

# pandas.read_csv's default missing values (pandas._libs.parsers.STR_NA_VALUES)
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                 "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                 "nan", "null"})


def read_csv_rows(path) -> Tuple[List[str], List[dict]]:
    """(column names, rows as {column: field}) of a CSV; a missing field
    (in pandas' default set, or past the end of a short row) is None."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        reader = csv.reader(f)
        columns = next(reader)
        rows = [{c: (None if v in _NA else v) for c, v in zip(columns, r)}
                for r in reader if r]
    return columns, rows


def _clean_text(text: str) -> str:
    """Strip quotes/parens (reference InferenceDataset.py:71-74)."""
    for ch in ('"', "'", "(", ")"):
        text = text.replace(ch, "")
    return text.strip()


def _field(row: dict, name: str) -> str:
    val = row.get(name)
    return "" if val is None else val


def _load_observations(reports_csv) -> dict:
    """VolumeName -> (Findings_EN, Impressions_EN)
    (reference TrainDataset.py:27-33)."""
    _, rows = read_csv_rows(reports_csv)
    return {row.get("VolumeName"): (_field(row, "Findings_EN"), _field(row, "Impressions_EN"))
            for row in rows}


def load_metadata(metadata_csv) -> dict:
    """VolumeName -> its first metadata row (process_file's lookup)."""
    meta = {}
    for row in read_csv_rows(metadata_csv)[1]:
        meta.setdefault(row.get("VolumeName"), row)
    return meta


def _load_labels(labels_csv) -> dict:
    """VolumeName -> float32 labels of every column after the first, a
    missing label NaN."""
    columns, rows = read_csv_rows(labels_csv)
    return {row.get("VolumeName"): np.asarray(
        [np.nan if row.get(c) is None else float(row[c]) for c in columns[1:]], np.float32)
        for row in rows}


def _walk_nii(data_folder):
    for root, _, files in os.walk(data_folder):
        for file in sorted(files):
            if file.endswith(".nii.gz"):
                yield os.path.join(root, file), file


def _cfg_digest(model_type: str, cfg: PreprocessConfig) -> str:
    """The JAX package's cache key digest: the same for the same settings,
    so the two share a cache directory."""
    return hashlib.md5(f"{model_type}|{cfg}".encode()).hexdigest()[:10]


def _cached_process(path, name, metadata: dict, model_type,
                    cfg: PreprocessConfig, cache_dir: Optional[str]):
    """process_file with an optional preprocessed-volume disk cache.

    The reference has no cache — every epoch re-inflates the .nii.gz
    (single-stream gzip, ~5 s/volume) and re-runs the resample chain. Here
    the finished tensor is stored once as raw .npy keyed by volume name +
    a digest of (model_type, PreprocessConfig); later epochs are one
    sequential read. Writes are atomic (tmp + os.replace) so concurrent
    workers sharing a cache directory race safely; unreadable entries fall
    through to a re-process."""
    if not cache_dir:
        return process_file(path, name, metadata, model_type, cfg)
    os.makedirs(cache_dir, exist_ok=True)
    stem = name[:-7] if name.endswith(".nii.gz") else os.path.splitext(name)[0]
    cpath = os.path.join(cache_dir, f"{stem}.{_cfg_digest(model_type, cfg)}.npy")
    if os.path.exists(cpath):
        try:
            return np.load(cpath)
        except (OSError, ValueError):
            pass
    image = process_file(path, name, metadata, model_type, cfg)
    if image is not None:
        tmp = f"{cpath}.{os.getpid()}.tmp.npy"
        try:
            np.save(tmp, image)
            os.replace(tmp, cpath)
        except OSError:  # full/read-only cache disk: serve without caching
            if os.path.exists(tmp):
                os.remove(tmp)
    return image


class TrainDataset:
    """Yields (image [1, D, H, W] float32, report_text)
    (reference TrainDataset.py:8-78)."""

    def __init__(self, data_folder, reports, metadata, num_samples: int = 5000,
                 model_type: str = "ctclip",
                 preprocess_cfg: PreprocessConfig = PreprocessConfig(),
                 cache_dir: Optional[str] = None):
        self.metadata = load_metadata(metadata)
        self.model_type = model_type
        self.preprocess_cfg = preprocess_cfg
        self.cache_dir = cache_dir
        observations = _load_observations(reports)

        self.samples: List[Tuple[str, str, str]] = []
        for path, file in _walk_nii(data_folder):
            if file not in observations:
                continue
            findings, impressions = observations[file]
            self.samples.append((path, findings + impressions, file))
        if num_samples < len(self.samples):
            self.samples = self.samples[:num_samples]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        path, text, name = self.samples[index]
        image = _cached_process(path, name, self.metadata, self.model_type,
                                self.preprocess_cfg, self.cache_dir)
        if image is None:
            raise RuntimeError(f"Error loading {path}")
        return image.astype(np.float32), _clean_text(text)


class InferenceDataset:
    """Yields (image [1, D, H, W], text, labels [18], name, path)
    (reference InferenceDataset.py:8-76)."""

    def __init__(self, data_folder, reports, metadata, labels,
                 num_samples: int = 500, model_type: str = "ctclip",
                 preprocess_cfg: PreprocessConfig = PreprocessConfig(),
                 cache_dir: Optional[str] = None):
        self.metadata = load_metadata(metadata)
        self.model_type = model_type
        self.preprocess_cfg = preprocess_cfg
        self.cache_dir = cache_dir
        observations = _load_observations(reports)
        by_name = _load_labels(labels)

        self.samples = []
        for path, file in _walk_nii(data_folder):
            if file not in observations or file not in by_name:
                continue
            findings, impressions = observations[file]
            self.samples.append(
                (path, findings + impressions, by_name[file], file))
        if num_samples and num_samples < len(self.samples):
            self.samples = self.samples[:num_samples]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        path, text, labels, name = self.samples[index]
        image = _cached_process(path, name, self.metadata, self.model_type,
                                self.preprocess_cfg, self.cache_dir)
        if image is None:
            raise RuntimeError(f"Error loading {path}")
        return (image.astype(np.float32), _clean_text(text),
                labels, name.replace(".nii.gz", ""), path)
