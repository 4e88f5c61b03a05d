"""The shared memory each CUDA kernel launch asks for, and the card's
per-block budget: the port's counterpart of the reference's VMEM budget
(``check_vmem`` of :mod:`repro.analysis.jaxpr_lint`).

A Python mirror of the launchers' sizes, from the block shapes, the head
dim, the dtype and the warp count:

* K1 (``csrc/salo_table_attention.cu``): ``smem_bytes<HD>`` for f32
  inputs (256 threads), ``mma_smem_bytes<HD, NW>`` for 16-bit ones, NW
  from ``warps_for(block_q)`` (``csrc/salo_mma.cuh``); both dynamic, the
  launcher raises the block's limit to them (``cudaFuncSetAttribute``).
* K2 (``csrc/salo_table_backward.cu``): ``dq_smem_bytes<HD>`` and
  ``dq_mma_smem_bytes<HD, NW>`` (2 warps at hd 256).
* K3: ``dkv_smem_bytes<HD>`` and ``dkv_mma_smem_bytes<HD, NW>`` (at most 4
  warps at hd 256), then the owner-tile sum, whose dynamic shared memory
  is the packed plan's ``R`` row indices (4 bytes each) beside its static
  bytes, with no raised limit: above 48 KiB in all the launch fails, so
  each target's largest sequence length is reported.
* K4 and K5 (``csrc/salo_decode_body.cuh``): static arrays only (the K/V
  tiles, q, the scores, the row and split stats), by dtype, KV type and
  head dim.

:func:`check_budget` holds every launch of every registry plan target
(``analysis/registry.plan_targets``, a block below the kernels' smallest
raised to it, as ``chip_smoke.py`` launches them) at head dims 64, 128
and 256 and in f32, bf16 and f16, and every decode instantiation, to the
H100's limits: an error finding for each launch over its limit. Each
``.cu`` file exports its own sizes through its ``ctypes`` library
(``salo_table_attention_smem``, ``salo_table_backward_smem``,
``salo_decode_smem``, ``salo_paged_decode_smem``): ``chip_smoke.py``'s
analysis phase holds this mirror to them for every instantiation
(:func:`instantiations`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis import Finding

# the H100's per-block limits: the opt-in dynamic limit (227 KiB,
# ``cudaDevAttrMaxSharedMemoryPerBlockOptin``) and the default one, which
# static shared memory never passes and a launch that does not raise its
# limit stays under
OPTIN_LIMIT = 232_448
DEFAULT_LIMIT = 48 * 1024
DTYPES = ("float32", "bfloat16", "float16")
DTYPE_CODE = {"float32": 0, "bfloat16": 1, "float16": 2}
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}
HEAD_DIMS = (64, 128, 256)
BLOCKS = (32, 64, 128, 256)        # kernels/salo_attention.BLOCKS

# csrc/salo_mma.cuh
K_SUB, K_BATCH, K_MAX_WARPS = 64, 8, 8
# csrc/salo_table_attention.cu
K1_ROWS, K1_KEYS, LD_T = 64, 64, 68
# csrc/salo_table_backward.cu
K2_ROWS, K23_KEYS, K3_QS, LD_Q = 64, 64, 32, 36
# csrc/salo_decode_body.cuh
DEC_THREADS, DEC_ROWS, DEC_MAX_SPLITS, DEC_TILE_BYTES = 256, 4, 64, 16384


def warps_for(b: int) -> int:
    """``salo::warps_for``: warps of a block over a plan block of ``b``
    rows (forward, dQ) or keys (dK/dV)."""
    return min(b, 16 * K_MAX_WARPS) // 16


def _cols(hd: int) -> int:
    """``acc_cols`` / ``staged_cols``: the hd columns a block holds."""
    return min(hd, 128)


def _walk(nw: int) -> int:
    """``walk_smem_bytes<NW>``: the mask walk's shared memory."""
    return K_BATCH * K_SUB * 4 + K_BATCH * 32 * nw * 4 + 2 * nw * 4 + 8


def k1_bytes(hd: int, nw: int = 0) -> int:
    """K1's dynamic bytes: ``smem_bytes<HD>`` (``nw`` 0: the f32
    kernel) or ``mma_smem_bytes<HD, NW>``."""
    if not nw:
        return (2 * hd * LD_T + K1_KEYS * (hd + 4) + K1_ROWS * LD_T) * 4 \
            + K1_KEYS * 4
    return (16 * nw * (hd + 8) + 2 * K_SUB * (hd + 8)
            + 2 * K_SUB * (_cols(hd) + 8)) * 2 + _walk(nw)


def k2_bytes(hd: int, nw: int = 0) -> int:
    """K2's dynamic bytes: ``dq_smem_bytes<HD>`` or
    ``dq_mma_smem_bytes<HD, NW>``."""
    if not nw:
        return (4 * _cols(hd) * LD_T + K23_KEYS * (hd + 4)
                + K2_ROWS * LD_T) * 4 + K23_KEYS * 4
    return (3 * 16 * nw + 4 * K_SUB) * (hd + 8) * 2 + _walk(nw)


def k3_bytes(hd: int, nw: int = 0) -> int:
    """K3's row walk's dynamic bytes: ``dkv_smem_bytes<HD>`` or
    ``dkv_mma_smem_bytes<HD, NW>`` (dout staged in f32 up to hd 128)."""
    if not nw:
        return (2 * _cols(hd) * (LD_T + LD_Q) + 2 * K3_QS * (hd + 4)
                + 2 * K23_KEYS * LD_Q + 3 * K3_QS) * 4 + K3_QS * 4
    stage = K_SUB * (hd + 8) * 2 + 3 * K_SUB * 4
    return ((2 * 16 * nw + 2 * K_SUB) * (hd + 8) * 2 + 3 * K_SUB * 4
            + (K_SUB * hd * 4 if hd <= 128 else 0) + 2 * stage + _walk(nw)
            + nw * 4)


# owner_sum_kernel's static shared memory: its one ``__shared__ int
# cnt``, which the compiler lays out in 16 bytes (ptxas: "16 bytes smem")
OWNER_SUM_STATIC = 16


def owner_sum_rows_cap() -> int:
    """The largest packed row count ``R`` whose owner-tile sum fits: its
    ``R`` int32 row indices beside its static bytes, within the default
    48 KiB."""
    return (DEFAULT_LIMIT - OWNER_SUM_STATIC) // 4


def _row_stride(x: int, n: int) -> int:
    """``row_stride``: the smallest stride >= x that is an odd multiple
    of n (any stride once n >= 8)."""
    if n >= 8:
        return x
    y = x
    while y % n or (y // n) % 2 == 0:
        y += 1
    return y


def decode_bytes(dtype: str, kv: str, hd: int) -> int:
    """The decode body's static bytes for compute type ``dtype``, cache
    type ``kv`` (``dtype`` or ``"int8"``) and head dim ``hd``: the K and V
    tiles (``Tile<KV, HD>::KV_BYTES``), q, the scores, the slot maxima,
    the row stats, the split partials and the ticket, and for an int8
    cache the slots' V scales (an fp cache never reads that array, and
    the compiler drops it)."""
    n = 16 // ITEMSIZE[kv]
    nc = hd // n
    ts = min(DEC_TILE_BYTES // (hd * ITEMSIZE[kv]), 128)
    tps = DEC_THREADS // ts
    kv_bytes = ts * (_row_stride(nc, tps) + _row_stride(nc, nc)) * 16
    return (kv_bytes + DEC_ROWS * hd * ITEMSIZE[dtype] + DEC_ROWS * ts * 4
            + (2 if kv == "int8" else 1) * ts * 4 + 3 * DEC_ROWS * 4
            + 2 * DEC_ROWS * DEC_MAX_SPLITS * 4 + 4)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch's shared memory: ``dynamic`` bytes (raised to
    with ``cudaFuncSetAttribute`` where ``opt_in``) beside ``static``
    ones, against the card's per-block limit."""
    kernel: str
    dtype: str
    hd: int
    nw: int = 0            # warps of a tensor-core block; 0: 256 threads
    dynamic: int = 0
    static: int = 0
    opt_in: bool = True
    kv: str = ""           # the decode cache's type

    @property
    def total(self) -> int:
        return self.dynamic + self.static

    @property
    def limit(self) -> int:
        return OPTIN_LIMIT if self.opt_in else DEFAULT_LIMIT

    def name(self) -> str:
        return (f"{self.kernel}[{self.dtype}"
                + (f"/{self.kv}" if self.kv else "") + f", hd {self.hd}"
                + (f", {self.nw} warps" if self.nw else "") + "]")


def table_launches(dtype: str, hd: int, block_q: int, block_k: int,
                   rows: Optional[int] = None) -> List[Launch]:
    """The launches of one forward + backward of the training op at
    these blocks, as the launchers pick their variant and warps: K1, K2,
    K3's row walk and (with the packed plan's ``rows``) its owner sum."""
    mma = dtype != "float32"

    def nw(b: int, cap: int = K_MAX_WARPS) -> int:
        w = warps_for(b)
        return 0 if not mma else w if w in (2, 4) and w <= cap else cap

    w1 = nw(block_q)
    w2 = 2 if mma and hd > 128 else nw(block_q)
    w3 = nw(block_k, 4) if hd > 128 else nw(block_k)
    out = [Launch("K1", dtype, hd, w1, k1_bytes(hd, w1)),
           Launch("K2", dtype, hd, w2, k2_bytes(hd, w2)),
           Launch("K3", dtype, hd, w3, k3_bytes(hd, w3))]
    if rows is not None:
        out.append(Launch("K3-owner-sum", dtype, hd, 0, rows * 4,
                          OWNER_SUM_STATIC, opt_in=False))
    return out


def decode_launches() -> List[Launch]:
    """Every decode instantiation: K4 (paged) with the cache in the
    compute type or int8, K5 (contiguous) in the compute type."""
    out = []
    for dtype in DTYPES:
        for hd in HEAD_DIMS:
            for kernel, kvs in (("K4", (dtype, "int8")), ("K5", (dtype,))):
                out += [Launch(kernel, dtype, hd, 0, 0,
                               decode_bytes(dtype, kv, hd), opt_in=False,
                               kv=kv) for kv in kvs]
    return out


def instantiations() -> List[Launch]:
    """Every (kernel, dtype, hd, warps) the ``.cu`` files instantiate:
    what their exported sizes are held to."""
    out = []
    for dtype in DTYPES:
        for hd in HEAD_DIMS:
            if dtype == "float32":
                ws = {"K1": (0,), "K2": (0,), "K3": (0,)}
            else:
                ws = {"K1": (2, 4, 8),
                      "K2": (2,) if hd > 128 else (2, 4, 8),
                      "K3": (2, 4) if hd > 128 else (2, 4, 8)}
            for kernel, fn in (("K1", k1_bytes), ("K2", k2_bytes),
                               ("K3", k3_bytes)):
                out += [Launch(kernel, dtype, hd, w, fn(hd, w))
                        for w in ws[kernel]]
    return out + [Launch("K3-owner-sum", "float32", 64, 0, 0,
                         OWNER_SUM_STATIC, opt_in=False)] + decode_launches()


def exported(x: Launch) -> int:
    """The bytes the ``.cu`` file of ``x``'s kernel states for its
    instantiation, through its library's export (built on first use;
    the card only: the decode and owner-sum numbers are the compiled
    kernels' own, read with ``cudaFuncGetAttributes``); -1 where the file
    instantiates none."""
    import ctypes

    from repro_torch.kernels._build import load

    ci = ctypes.c_int
    code = DTYPE_CODE[x.dtype]
    if x.kernel == "K1":
        fn, args = load("salo_table_attention").salo_table_attention_smem, \
            (code, x.hd, x.nw)
    elif x.kernel in ("K2", "K3", "K3-owner-sum"):
        kernel = {"K2": 0, "K3": 1, "K3-owner-sum": 2}[x.kernel]
        fn, args = load("salo_table_backward").salo_table_backward_smem, \
            (kernel, code, x.hd, x.nw)
    elif x.kernel == "K4":
        fn, args = load("salo_paged_decode").salo_paged_decode_smem, \
            (code, int(x.kv == "int8"), x.hd)
    else:
        fn, args = load("salo_decode").salo_decode_smem, (code, x.hd)
    fn.argtypes, fn.restype = [ci] * len(args), ci
    return int(fn(*args))


def _rows_fn(pattern, block_q: int, block_k: int) -> Callable[[int], int]:
    from repro_torch.core.scheduler import schedule

    def rows(nkb: int) -> int:
        return schedule(pattern, nkb * block_k).plan(
            block_q, block_k).transposed_packed().n_rows
    return rows


def max_owner_sum_n(pattern, block_q: int, block_k: int) -> int:
    """The largest sequence length (a whole number of key tiles) at
    which the packed plan's row count still fits the owner sum
    (:func:`owner_sum_rows_cap`). The count grows about linearly in the
    key tiles: a guess from two sizes, then a bracket and a bisection."""
    rows, cap = _rows_fn(pattern, block_q, block_k), owner_sum_rows_cap()
    r1, r2 = rows(256), rows(512)
    slope = max((r2 - r1) / 256, 1e-3)
    g = max(1, 512 + int((cap - r2) / slope))
    r = rows(g)
    step = max(1, math.ceil(abs(r - cap) / slope))
    if r <= cap:
        lo, hi = g, g + step
        while rows(hi) <= cap:
            lo, hi = hi, hi + 2 * step
    else:
        lo, hi = max(1, g - step), g
        while lo > 1 and rows(lo) > cap:
            lo, hi = max(1, lo - 2 * step), lo
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if rows(mid) <= cap else (lo, mid)
    return lo * block_k


def target_blocks(t) -> Tuple[int, int]:
    """A registry target's blocks as the kernels take them: a block below
    the smallest raised to it."""
    return max(t.block_q, min(BLOCKS)), max(t.block_k, min(BLOCKS))


def check_launches(launches: List[Launch], target: str) -> List[Finding]:
    """An error finding for each launch over its per-block limit."""
    return [Finding(
        "smem-budget", target,
        f"{x.name()} asks for {x.total} bytes of shared memory a block "
        f"({x.dynamic} dynamic + {x.static} static), over the "
        f"{x.limit}-byte {'opt-in' if x.opt_in else 'default'} limit")
        for x in launches if x.total > x.limit]


def check_budget(targets, with_max_n: bool = True
                 ) -> Tuple[List[Finding], List[Dict]]:
    """Every launch of every plan target (K1-K3 and the owner sum at the
    target's n) at each head dim and dtype, and every decode
    instantiation, against the limits. Returns the findings and one row
    a target: its blocks, its packed row count, the largest shared-memory
    launch and (``with_max_n``) the largest sequence length its owner sum
    takes (``None`` for a 2-D pattern, whose length is its grid's)."""
    from repro_torch.core.scheduler import schedule

    findings: List[Finding] = []
    rows_out: List[Dict] = []
    for t in targets:
        bq, bk = target_blocks(t)
        R = schedule(t.pattern, t.n).plan(bq, bk).transposed_packed().n_rows
        worst = None
        for dtype in DTYPES:
            for hd in HEAD_DIMS:
                ls = table_launches(dtype, hd, bq, bk, R)
                findings += check_launches(ls, f"smem[{t.name}]")
                big = max((x for x in ls if x.opt_in), key=lambda x: x.total)
                if worst is None or big.total > worst.total:
                    worst = big
        max_n = None if t.pattern.is_2d or not with_max_n else \
            max_owner_sum_n(t.pattern, bq, bk)
        rows_out.append(dict(target=f"smem[{t.name}]", blocks=(bq, bk),
                             n=t.n, rows=R, largest=worst.name(),
                             largest_bytes=worst.total,
                             owner_sum_max_n=max_n))
    findings += check_launches(decode_launches(), "smem[decode]")
    return findings, rows_out
