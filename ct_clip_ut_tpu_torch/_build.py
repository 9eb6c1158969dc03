"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file compiles, with `nvcc` by hand, to an object file,
all of them at once in parallel processes; one more `nvcc` links them into
ONE shared library with a plain C interface, loaded with `ctypes` (no
PyTorch headers, so the build takes seconds, not minutes). The library goes
to `build/ct_clip_ut_tpu_torch/` at the root of the checkout, named after a
hash of the sources and flags: editing a source rebuilds, an unchanged tree
reuses the file. The compiler's per-kernel register and shared-memory
report (`-Xptxas -v`) is kept beside it as `<lib>.log`.

Nothing here runs at import time: the first CUDA launch calls `load()`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "ct_clip_ut_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
# C entry -> argtypes; every entry returns cudaGetLastError() as an int
SIGNATURES = {
    "ctc_attn_block": [_P] * 14 + [_I] * 4 + [_F, _I, _P],
    "ctc_attn_packed": [_P] * 13 + [_I] * 4 + [_F, _I, _P],
    "ctc_attn_block_f32": [_P] * 17 + [_I] * 4 + [_F, _I, _I, _P],
    "ctc_attn_packed_f32": [_P] * 15 + [_I] * 4 + [_F, _I, _I, _P],
    "ctc_attn_qrows": [_P] * 15 + [_I] * 5 + [_F, _I, _P],
    "ctc_attn_qrows_f32": [_P] * 17 + [_I] * 5 + [_F, _I, _I, _P],
    "ctc_geglu_ff": [_P] * 8 + [_I] * 6 + [_P],
    "ctc_geglu_ff_f32": [_P] * 10 + [_I] * 7 + [_P],
    "ctc_vq_nearest": [_P] * 4 + [_I] * 5 + [_P],
    "ctc_vq_nearest_f32": [_P] * 6 + [_I] * 4 + [_P],
    "ctc_patch_embed": [_P] * 9 + [_I] * 9 + [_P],
    "ctc_patch_embed_res": [_P] * 10 + [_I] * 9 + [_P],
    "ctc_patch_embed_f32": [_P] * 10 + [_I] * 9 + [_P],
    "ctc_patch_embed_res_f32": [_P] * 11 + [_I] * 9 + [_P],
    "ctc_patchify_f32": [_P] * 2 + [_I] * 8 + [_P],
    "ctc_patch_embed_dkw": [_P] * 3 + [_I] * 8 + [_P],
    "ctc_patch_embed_dkw_f32": [_P] * 4 + [_I] * 9 + [_P],
    "ctc_patchify": [_P] * 2 + [_I] * 7 + [_P],
    "ctc_attn_block_bwd": [_P] * 34 + [_I] * 4 + [_F, _I, _P],
    "ctc_attn_packed_bwd": [_P] * 31 + [_I] * 4 + [_F, _I, _P],
    "ctc_attn_block_bwd_f32": [_P] * 37 + [_I] * 4 + [_F, _I, _I, _I, _P],
    "ctc_attn_packed_bwd_f32": [_P] * 34 + [_I] * 4 + [_F, _I, _I, _I, _P],
    "ctc_geglu_ff_bwd": [_P] * 17 + [_I] * 5 + [_P],
    "ctc_geglu_ff_bwd_f32": [_P] * 18 + [_I] * 7 + [_P],
    "ctc_bert_layer": [_P] * 31 + [_I] * 6 + [_F, _F, _U, _U, _F, _F, _P],
    "ctc_bert_layer_bwd_f32": [_P] * 55 + [_I] * 6 + [_F, _F, _U, _U, _F, _F, _P],
    "ctc_bert_layer_bf16": [_P] * 27 + [_I] * 7 + [_F, _F, _U, _U, _F, _F, _P],
    "ctc_bert_layer_bwd": [_P] * 53 + [_I] * 7 + [_F, _F, _U, _U, _F, _F, _P],
    "ctc_bert_keep_mask": [_P, _U, _I, _I, _I, _U, _F, _P, _P],
    "ctc_peg": [_P] * 4 + [_I] * 10 + [_P],
    "ctc_peg_wgrad": [_P] * 4 + [_I] * 9 + [_P],
    "ctc_geglu_ff_int8": [_P] * 15 + [_I] * 4 + [_P],
    "ctc_geglu_ff_int8_f32": [_P] * 15 + [_I] * 4 + [_P],
    "ctc_cosine_attention": [_P] * 8 + [_I] * 4 + [_F, _P],
    "ctc_gemm_sm90_check": [_P] * 3 + [_I] * 6 + [_P],
    "ctc_wgrad_sm90_check": [_P] * 3 + [_I] * 5 + [_P],
    "ctc_attn_block_max_n": [],
    "ctc_attn_packed_max_n": [],
    "ctc_attn_f32_max_n": [],
    "ctc_attn_bwd_max_n": [],
    "ctc_attn_bwd_f32_max_n": [],
    "ctc_cosine_attention_max_m": [],
}


def sources() -> list:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from source and cannot run without it")


def build() -> Path:
    """Compile the library unless a build of the same sources exists."""
    lib = BUILD_DIR / f"libctclip_kernels_{source_hash()}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in (p for p in sources() if p.suffix == ".cu"):
            objs.append(str(Path(tmp) / f"{src.stem}.o"))
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", objs[-1], str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        failed = [(p.args[-1], log) for p, log in zip(procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{src}:\n{log[-8000:]}" for src, log in failed))
        so = str(Path(tmp) / "lib.so")
        res = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", so, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-8000:]}")
        Path(str(lib) + ".log").write_text("".join(logs) + res.stdout + res.stderr)
        os.replace(so, lib)   # atomic: concurrent builders never see a torn file
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use in this process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def require(t, name: str, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous tensor of this dtype and shape on
    `device`: the kernels take nothing else."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def aligned16(t):
    """t, or a copy of it when its data is not 16-B aligned (the kernels
    read rows with 16-B loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# TMA (csrc/gemm_sm90.cuh) takes a 2-D operand only with a 16-B aligned base
# address and a row stride that is a multiple of 16 B
TMA_ALIGN = 16


def tma_pitch(cols: int, itemsize: int = 2) -> int:
    """The row length, in elements, of a TMA operand with `cols` columns:
    `cols` rounded up to a whole number of 16-B units."""
    step = TMA_ALIGN // itemsize
    return -(-cols // step) * step


def tma_rows(t):
    """(operand, row stride in elements) of a contiguous 2-D tensor for TMA:
    the tensor itself where its rows are 16-B strided and its data 16-B
    aligned, else a zero-padded copy [rows, tma_pitch(cols)]. The copy is
    made on every call, never cached: a train step updates weights in
    place, and a cached copy would go stale."""
    rows, cols = t.shape
    pitch = tma_pitch(cols, t.element_size())
    if pitch == cols and t.data_ptr() % TMA_ALIGN == 0:
        return t, cols
    padded = t.new_zeros((rows, pitch))
    padded[:, :cols] = t
    return padded, pitch


def check_device(device) -> torch.device:
    """torch.device(device); asking for the card on a machine without one
    raises instead of building on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's entry points run on the card; "
                           "pass device='cpu' to run the plain versions on the CPU")
    return dev


def on_cuda(x) -> bool:
    """True for a CUDA tensor, False for a CPU tensor (which takes the plain
    version); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def stream_of(x) -> int:
    """The handle of PyTorch's current stream on x's device."""
    return torch.cuda.current_stream(x.device).cuda_stream
