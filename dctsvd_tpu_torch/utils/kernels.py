"""Build and load the hand-written CUDA kernels: K1 and the C entry points
of K2 and K3 (``wm_kernels.cu``), the K2 and K3 instances of each k
(``wm_paint_k12.cu`` .. ``wm_paint_k78.cu``, over ``wm_paint.cuh``), K2r,
K1g (``wm_variants.cu``), K4 (``svd8.cu``), the extract tail's presence
statistic K18 (``presence.cu``), its front stage K5f, its default form's
normaliser K8 (with its crop K8u) and its recompute form K5
(``extract_tail.cu``), the gray scheme's
color conversions K6 and K7 and the color NLM's YCrCb pair K17
(``color.cu``), the detect statistic K9 (``detect.cu``), the enhancement
chain's NLM K10, CLAHE K11 and unsharp K14 (``enhance.cu``), the embed
metrics SSIM K15 and PSNR K16 (``metrics.cu``; K14 and K15 share the blur
of ``blur.cuh``), detect resync's roll stack K12 and counter-rotation K13
(``resync.cu``), and the tools probes
copy_f32, cols_view, fma_chain and spectrum_probe (``probes.cu``).

At first use :func:`load` compiles every ``dctsvd_tpu_torch/csrc/*.cu``
into one shared library with a plain C interface and loads it with
ctypes. Each source compiles in its own nvcc process, all started
together, and one more nvcc links the objects:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -fmad=false -Xptxas -v -c csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o libdctsvd_kernels.so <name>.o ...

``-fmad=false`` stops nvcc from contracting a multiply and an add into one
FMA, so each kernel rounds exactly as its plain twin (one PyTorch op per
arithmetic step) does on the card; with contraction, blocks whose singular
values nearly coincide rotate differently and K2's stego bytes differed
from the twin's by up to 11 quanta. No ``--use_fast_math``: it would change
``sqrtf`` and division. ``-Xptxas -v`` only reports each kernel's registers
and spills; the log is kept in :data:`BUILD_INFO`. The library lands in
``build/dctsvd_tpu_torch/<hash of sources + flags>/`` under the repository
root, so an edited source always rebuilds. Importing this module builds
nothing; a failed build raises :class:`KernelError` with nvcc's stderr,
and so does a launch that returns a CUDA error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "dctsvd_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v"]
LIB_NAME = "libdctsvd_kernels.so"

#: Filled by :func:`load`: library path, build seconds (0.0 when the
#: library was already built), and nvcc's register/spill report.
BUILD_INFO: dict = {}
_LIB: list = []

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "dctsvd_spectrum_blocks": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _P],
    "dctsvd_embed_blocks": [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                            _I, _I, _P],
    "dctsvd_roundtrip_blocks": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _P],
    "dctsvd_embed_recon_blocks": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _P],
    "dctsvd_spectrum_gram_blocks": [_P, _I, _P, _I, _I, _I, _I, _I, _I,
                                    _P],
    "dctsvd_svd8": [_P, _P, _P, _P, _LL, _I, _I, _I, _P],
    "dctsvd_copy_f32": [_P, _P, _LL, _I, _P],
    "dctsvd_cols_view": [_P, _I, _P, _I, _LL, _I, _I, _I, _P],
    "dctsvd_fma_chain": [_P, _P, _LL, _I, _I, _I, _P],
    "dctsvd_spectrum_probe": [_P, _I, _I, _I, _P, _I, _I, _I, _I, _P],
    "dctsvd_extract_tail": [_P, _I, _P, _LL, _P, _I, _P, _I, _I, _I, _I, _I,
                            _I, _I, _P],
    "dctsvd_tail_front": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _P],
    "dctsvd_normalize_blocks": [_P, _LL, _LL, _P, _LL, _I, _P, _I, _P, _I,
                                _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "dctsvd_device_limits": [_P],
    "dctsvd_presence": [_P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P, _I, _P, _LL,
                        _LL, _P, _P, _P, _LL, _I, _I, _F, _P],
    "dctsvd_luma": [_P, _P, _I, _I, _I, _I, _I, _P],
    "dctsvd_replace_luma": [_P, _P, _P, _I, _I, _I, _I, _P],
    "dctsvd_band_scores": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "dctsvd_nlm": [_P, _P, _P, _I, _I, _I, _P],
    "dctsvd_nlm_weights": [_P, _P, _I, _P],
    "dctsvd_clahe_luts": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dctsvd_clahe_apply": [_P, _P, _P, _I, _I, _I, _I, _P],
    "dctsvd_clahe": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dctsvd_unsharp": [_P, _P, _P, _F, _F, _I, _I, _I, _I, _P],
    "dctsvd_ssim": [_P, _P, _I, _P, _P, _P, _F, _F, _P, _P, _I, _I, _I, _P],
    "dctsvd_sq_diff": [_P, _P, _LL, _I, _P, _I, _P],
    "dctsvd_ycrcb": [_P, _P, _I, _I, _I, _I, _I, _P],
    "dctsvd_roll_stack": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dctsvd_derotate": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}


class KernelError(RuntimeError):
    """A kernel that did not build (nvcc missing or failing) or whose
    launch returned a CUDA error: a fault of the device path, which no
    caller may skip past as a failed stage."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA kernels need the CUDA "
                          "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def ptxas_report(log: str) -> dict:
    """``{mangled kernel name: {"stack_frame", "spill_stores",
    "spill_loads", "registers"}}`` (bytes, and registers per thread) from
    nvcc's ``-Xptxas -v`` log (:data:`BUILD_INFO` ``["ptxas"]``); each
    template instance has its own mangled name."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = {}
        elif name and "spill stores" in ln:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            out[name].update(stack_frame=int(m[1]), spill_stores=int(m[2]),
                             spill_loads=int(m[3]))
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   ln)[1])
            name = None
    return out


# SASS opcodes (before the first '.') by class, for sass_mix.
_SASS_CLASSES = {
    "f32": ("FADD", "FMUL", "FFMA", "FMNMX", "FADD32I", "FMUL32I",
            "FFMA32I"),
    "f32_compare_select": ("FSETP", "FSEL", "FSET", "FCHK"),
    "mufu": ("MUFU",),
    "conversion": ("I2F", "F2I", "F2F", "I2FP", "F2IP", "FRND"),
    "integer": ("IMAD", "IADD3", "IADD", "LOP3", "SHF", "LEA", "ISETP",
                "SEL", "IABS", "PRMT", "IMNMX", "MOV", "IMUL", "FLO",
                "POPC", "ISCADD"),
    "load": ("LDG", "LDS", "LD", "LDC", "LDL"),
    "store": ("STG", "STS", "ST", "STL"),
    "async_copy": ("LDGSTS", "LDGDEPBAR", "DEPBAR"),
    "shuffle": ("SHFL",),
}
_SASS_CLASS = {op: cls for cls, ops in _SASS_CLASSES.items() for op in ops}
_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_mix(sass: str, sweeps: float) -> dict:
    """``{mangled kernel name: {"main", "sweep", "per_lane", "loops"}}``: the
    instructions of each kernel of ``cuobjdump -sass`` output by class
    (``_SASS_CLASSES``; "other" for the rest, NOPs left out). "main" counts
    the kernel's body once, up to the branch-to-self that ends it (the
    slow-path subroutines of IEEE division and square root after it are
    left out); "sweep" the body of its outermost loop (the `full` sweeps of
    jacobi8, one sweep of 28 pairs; empty without a loop). "per_lane" is
    what one lane executes at ``sweeps`` (a whole number of sweeps plus
    a fraction of one), counting the loop body once per sweep, on the
    assumption that the unrolled pair prefix after the loop compiles to
    the same instructions as the loop body and runs the same fraction
    of them: main + sweep * (sweeps - 2). "loops" counts the body of every
    loop (each backward branch), in the order they end, inner loops
    before the loops around them."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        # a branch names its target by label (`(.L_x_3)`) or by address
        labels, insns = {}, []
        for ln in part.splitlines():
            s = ln.strip()
            if s.startswith(".L_") and s.endswith(":"):
                labels[s[:-1]] = len(insns)
                continue
            m = _SASS_INSN.search(ln)
            if m:
                labels[int(m[1], 16)] = len(insns)
                insns.append((m[2].split(".")[0], m[3]))
        end, loop, loops = len(insns), None, []
        for i, (op, rest) in enumerate(insns):
            t = re.search(r"\(\s*(\.L_\w+)\s*\)|\b0x([0-9a-f]+)\b", rest)
            target = t and (t[1] or int(t[2], 16))
            if op == "BRA" and target in labels:
                j = labels[target]
                if j == i:               # the branch-to-self after EXIT
                    end = i
                    break
                if j < i:
                    loops.append((j, i + 1))
                if j < i and (loop is None or i - j > loop[1] - loop[0]):
                    loop = (j, i + 1)

        def count(lo, hi):
            c = {}
            for op, _ in insns[lo:hi]:
                if op != "NOP":
                    cls = _SASS_CLASS.get(op, "other")
                    c[cls] = c.get(cls, 0) + 1
            return c

        main = count(0, end)
        sweep = count(*loop) if loop else {}
        per_lane = {k: main.get(k, 0) + sweep.get(k, 0) * (sweeps - 2)
                    for k in main}
        out[name] = dict(main=main, sweep=sweep, per_lane=per_lane,
                         loops=[count(*lp) for lp in loops])
    return out


def sass_dump(path: str) -> str:
    """``cuobjdump -sass`` of the library at ``path`` (the toolkit's
    cuobjdump, beside nvcc)."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def _sources():
    cu = sorted(_CSRC.glob("*.cu"))
    hashed = sorted(_CSRC.glob("*.cu*"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in hashed:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return cu, h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands in parallel; raise with nvcc's output if any
    fails, else return their stderr and stdout."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (so, se) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise KernelError(f"nvcc failed ({p.returncode}): "
                              f"{' '.join(cmd)}\n{se}{so}")
    return "".join(se + so for so, se in outs)


def _build(out: Path, cu) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out.with_name(f"{f.stem}.{tag}.o") for f in cu]
    tmp = out.with_name(f"{out.name}.{tag}")
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)]
                        for f, o in zip(cu, objs)])
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, ptxas=log)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    if _LIB:
        return _LIB[0]
    cu, digest = _sources()
    out = _BUILD_ROOT / digest / LIB_NAME
    BUILD_INFO.update(path=str(out), seconds=0.0, ptxas="")
    if not out.exists():
        _build(out, cu)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB.append(lib)
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a nonzero cudaError_t."""
    if err != 0:
        raise KernelError(f"{what}: CUDA kernel launch failed "
                          f"(cudaError_t {err})")


def launch(fn: str, device, *args) -> None:
    """Call the C launcher ``fn`` on the current stream of ``device`` and
    raise if the launch failed. Tensors are passed as their data
    pointers, everything else as it is."""
    import torch
    lib = load()
    cargs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
             else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*cargs, ctypes.c_void_p(stream))
    check(err, fn)
