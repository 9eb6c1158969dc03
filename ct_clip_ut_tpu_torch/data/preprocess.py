"""CT preprocessing chain: HU transform, spacing resample, clamp/scale,
crop/pad.

Counterpart of ct_clip_ut_tpu/data/preprocess.py (reference
src/utils/preprocess.py:20-151). For "ctclip": raw [H, W, D] voxels -> HU
via metadata RescaleSlope/Intercept -> permute to [D, H, W] -> trilinear
resample to (1.5, 0.75, 0.75) mm spacing -> clamp [-1000, 1000] HU, /1000
-> center-crop / symmetric-pad to (480, 480, 240) in (H, W, D) order with
pad -1 -> [1, 240, 480, 480]. For "ctgenerate": clamp/scale then trilinear
resize to (201, 128, 128).

PyTorch on the host CPU, in fp32, as the JAX package runs its chain on its
host CPU backend (per-sample shapes vary): the resample is
F.interpolate(mode="trilinear", align_corners=False), which the JAX
package's `resize_trilinear` reproduces. The JAX package's fused C++ chain
(native/) is not ported yet (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import PreprocessConfig


def resize_trilinear(vol: torch.Tensor, new_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Trilinear resample of a [D, H, W] fp32 volume at half-pixel centres,
    without anti-aliasing (reference preprocess.py:20-37)."""
    if tuple(vol.shape) == tuple(new_shape):
        return vol
    return F.interpolate(vol[None, None], size=tuple(new_shape), mode="trilinear",
                         align_corners=False)[0, 0]


def spacing_resample_shape(shape_dhw, current_spacing, target_spacing):
    """int(dim * current/target) per axis (reference preprocess.py:33-35)."""
    return tuple(int(shape_dhw[i] * current_spacing[i] / target_spacing[i])
                 for i in range(3))


def crop_and_pad(vol_hwd: torch.Tensor, target_shape: Tuple[int, int, int],
                 pad_value: float = -1.0) -> torch.Tensor:
    """Center crop / symmetric pad an [H, W, D] volume per axis
    (reference preprocess.py:39-82)."""
    out = vol_hwd
    for i in range(3):
        size, target = out.shape[i], target_shape[i]
        if size > target:
            out = out.narrow(i, (size - target) // 2, target)
        elif size < target:
            before = (target - size) // 2
            parts = []
            for width in (before, target - size - before):
                shape = list(out.shape)
                shape[i] = width
                parts.append(torch.full(shape, pad_value, dtype=out.dtype))
            out = torch.cat([parts[0], out, parts[1]], dim=i)
    return out


def process_volume(raw_hwd: np.ndarray, slope: float, intercept: float,
                   z_spacing: float, xy_spacing: float,
                   model_type: str = "ctclip",
                   cfg: PreprocessConfig = PreprocessConfig()) -> np.ndarray:
    """Full chain on one raw voxel grid (reference process_file,
    preprocess.py:84-151). Input is the NIfTI [H, W, D] array; returns
    [1, D, H, W] float32."""
    vol = torch.as_tensor(np.asarray(raw_hwd, np.float32))
    vol = slope * vol + intercept                         # HU
    vol = vol.permute(2, 0, 1)                            # [D, H, W]

    if model_type == "ctclip":
        new_shape = spacing_resample_shape(
            vol.shape, (z_spacing, xy_spacing, xy_spacing), cfg.target_spacing)
        vol = resize_trilinear(vol.contiguous(), new_shape)

    vol = torch.clamp(vol, cfg.hu_min, cfg.hu_max) / cfg.hu_max

    if model_type == "ctclip":
        vol = crop_and_pad(vol.permute(1, 2, 0), cfg.target_shape_hwd, cfg.pad_value)
        vol = vol.permute(2, 0, 1)                        # [D, H, W]
    elif model_type == "ctgenerate":
        vol = resize_trilinear(vol.contiguous(), cfg.ctgenerate_shape)

    return vol.contiguous().numpy()[None]                 # [1, D, H, W]


def parse_xy_spacing(raw: str) -> float:
    """First element of the stringified spacing list, parsed exactly like the
    reference (`row["XYSpacing"].iloc[0][1:][:-2].split(",")[0]`,
    preprocess.py:112): works for '[a, b]'-style strings."""
    return float(str(raw)[1:][:-2].split(",")[0])


def process_file(file_path, file_name, metadata: dict, model_type: str = "ctclip",
                 cfg: PreprocessConfig = PreprocessConfig(),
                 use_native: Optional[bool] = None) -> Optional[np.ndarray]:
    """CSV-metadata-driven wrapper (reference preprocess.py:84-151). Returns
    [1, D, H, W] float32 or None on read/metadata failure. `metadata` maps
    VolumeName to its metadata row (`datasets.read_csv_rows`, the first row
    of a name).

    use_native: True asks for the JAX package's fused C++ chain, which is
    not ported (raises); None and False take the torch chain."""
    from .nifti import read_nii_data

    if use_native:
        raise NotImplementedError("the fused C++ preprocessing chain is not ported yet "
                                  "(ROADMAP Queue 1 item 13); use_native=None takes the torch "
                                  "chain")
    raw = read_nii_data(file_path)
    if raw is None:
        print(f"Read failure for {file_path}.")
        return None

    row = metadata.get(file_name)
    if row is None:
        print(f"No metadata found for {file_name}.")
        return None
    try:
        slope = float(row["RescaleSlope"])
        intercept = float(row["RescaleIntercept"])
        xy_spacing = parse_xy_spacing(row["XYSpacing"])
        z_spacing = float(row["ZSpacing"])
    except Exception as e:  # noqa: BLE001 — parity with reference behavior
        print(f"Error processing metadata for {file_name}: {e}")
        return None

    return process_volume(np.asarray(raw, np.float32), slope, intercept,
                          z_spacing, xy_spacing, model_type, cfg)
