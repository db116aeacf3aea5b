"""Device rule and build-and-load of the port's CUDA kernels.

The tensor's device picks the path, and nothing else does:

* a CPU tensor goes through the kernel's plain PyTorch version;
* a CUDA tensor goes through the hand-written CUDA kernel, or the
  wrapper raises.  There is no fallback from the kernel to the plain
  version and no switch that routes CUDA tensors to it.

The kernels live in ``kernels/csrc`` as CUDA C++ with a plain C
interface.  ``load_library`` compiles them with ``nvcc`` for ``sm_90a``
into one shared library at first use — one ``nvcc`` per source, all
started together, then one link — keyed by a hash of the sources and
flags, and loads it with ``ctypes``.  Nothing is built when a module is
imported, so the CPU tests import every module on a machine without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: build outputs, one sub-directory per source hash (listed in .gitignore)
BUILD_ROOT = Path(__file__).resolve().parent / "_build"

#: No fast math: the decoded means are compared bit for bit, so float
#: division and conversions must stay IEEE round-to-nearest.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    # x, keys, out, l, d, m, counter_base, scale, clip, stream
    "repro_share_gen_batch": (_P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_uint, ctypes.c_float,
                              ctypes.c_float, _P),
    # x, out, d, m, key0, key1, hi_base, scale, clip, stream
    "repro_share_gen": (_P, _P, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                        ctypes.c_float, ctypes.c_float, _P),
    # x, keys, out, l, d, m, degree, counter_base, scale, clip, stream
    "repro_shamir_share_batch": (_P, _P, _P, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_uint,
                                 ctypes.c_float, ctypes.c_float, _P),
    # x, out, d, m, degree, key0, key1, hi_base, scale, clip, stream
    "repro_shamir_share": (_P, _P, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                           ctypes.c_uint, ctypes.c_float, ctypes.c_float,
                           _P),
    # shares, out, m, d, inv_scale, n, stream
    "repro_reconstruct": (_P, _P, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_float, _P),
    # sums, weights, out, k, d, inv_scale, n, stream
    "repro_shamir_reconstruct": (_P, _P, _P, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_float,
                                 ctypes.c_float, _P),
    # rows, commits, points, out, k, d, c, stream
    "repro_verify_shares": (_P, _P, _P, _P, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_int, _P),
    # q, k, v, out, b, hq, hkv, sq, skv, d, q/k/v strides (b, h, s),
    # scale, causal, window, dtype, stream
    "repro_flash_attention": (_P, _P, _P, _P, *(ctypes.c_int,) * 6,
                              *(ctypes.c_longlong,) * 9, ctypes.c_float,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, _P),
    # q, k, v, acc, m, l, out, the splits' acc, m, l, b, hq, hkv, d,
    # kv_len, splits, chunk, q strides (b, h), k/v strides (b, h, s),
    # scale, q dtype, kv dtype, stream
    "repro_decode_attention": (*(_P,) * 10, *(ctypes.c_int,) * 7,
                               *(ctypes.c_longlong,) * 8, ctypes.c_float,
                               ctypes.c_int, ctypes.c_int, _P),
    # x, dt, bc, cc, a, y, b, s, di, st, bc/cc strides (b, s), dtype,
    # stream
    "repro_ssm_scan": (*(_P,) * 6, *(ctypes.c_int,) * 4,
                       *(ctypes.c_longlong,) * 4, ctypes.c_int, _P),
    # a, b, h, b, s, w, dtype, stream
    "repro_lru_scan": (_P, _P, _P, *(ctypes.c_int,) * 4, _P),
}

#: C functions of the library that launch no kernel: the selective
#: scan's launch plan
_UTILITIES = {
    # b, di, st, dtype, out[10]
    "repro_ssm_scan_plan": (*(ctypes.c_int,) * 4, _P),
}

#: element-type codes of the float kernels' C interface
#: (``csrc/attention.cuh``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches per kernel since the last ``reset_launches`` — a wrapper adds
#: one where it launches its kernel and nowhere else, so a run can show
#: that its main path went through the kernels.
launches: dict[str, int] = {name: 0 for name in _SIGNATURES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; the card unless asked otherwise.

    Raises ``RuntimeError`` when the card is asked for and there is none:
    nothing falls back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and this "
                "machine has none; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: cuda or cpu")
    return dev


def on_cpu(*tensors) -> bool:
    """True when the plain version must run: every tensor on the CPU.

    A CUDA tensor selects the kernel; any other device, or a mix of
    devices, raises.
    """
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(
        f"kernel inputs must all lie on the CPU or all on one CUDA "
        f"device, got {sorted(str(t.device) for t in tensors)}")


@functools.lru_cache(maxsize=128)
def device_ints(values: tuple[int, ...], device: torch.device):
    """Small host ints (below 2^31) as an ``int32`` tensor on the card,
    copied once per tuple: a copy from host memory waits for the card to
    finish its queue."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def _source_files() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _source_files():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def _build(out_dir: Path) -> str:
    """Compile every ``.cu`` in parallel, link one ``.so``; returns the log."""
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT))
    try:
        procs = []
        for src in _source_files():
            if src.suffix != ".cu":
                continue
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib = tmp / "libreprokernels.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "build.log").write_text("\n".join(log))
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not (out_dir / "libreprokernels.so").exists():
                raise
            # another process finished the same build first
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return "\n".join(log)


@functools.lru_cache(maxsize=None)
def _load() -> tuple[ctypes.CDLL, dict]:
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / "libreprokernels.so"
    info = {"built": False, "seconds": 0.0, "path": str(lib_path)}
    if not lib_path.exists():
        t0 = time.perf_counter()
        _build(out_dir)
        info.update(built=True, seconds=time.perf_counter() - t0)
    info["log"] = (out_dir / "build.log").read_text()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in {**_SIGNATURES, **_UTILITIES}.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib, info


def load_library() -> dict:
    """Build (if needed) and load the kernels; returns build facts."""
    return _load()[1]


def utility(name: str):
    """A C function of the library that launches no kernel
    (``_UTILITIES``), built and bound; it returns a CUDA error code."""
    if name not in _UTILITIES:
        raise KeyError(f"{name} is not a utility of the kernel library")
    return getattr(_load()[0], name)


def launch(name: str, *args) -> None:
    """Call kernel ``name`` on the current stream; raise on a launch error.

    Pointers are passed as ``data_ptr()`` ints; the caller keeps the
    tensors alive for the duration of the call.
    """
    lib, _ = _load()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name}: CUDA launch failed with error {rc} "
            f"({lib.repro_error_string(rc).decode()})")
    launches[name] += 1
