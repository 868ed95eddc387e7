"""
The kinematic Green's-function stack — kernels K3 and K4 (port of
``beat_tpu/ops/gfstack.py``), THE hot op of kinematic FFI.

For the library ``data[target, patch, duration, starttime, sample]`` and
a lockstep batch of ``C`` chains:

    out[c, t, n] = Σ_p slips[c, p] · Σ_corner w_corner ·
        data[t, p, didx[c,p]∓, sidx[c,t,p]∓, n]

K3 (multilinear) blends the four (duration, starttime) cells around each
patch's onset, with the floor-cell weights ``rtf`` and ``stf``:
``rf·sf, rf·(1−sf), (1−rf)·sf, (1−rf)·(1−sf)`` on cells
``(d−1, s−1), (d−1, s), (d, s−1), (d, s)``.  K4 (nearest neighbour)
takes the one rounded cell ``(d, s)``.  The weights are used as given:
an onset beyond the starttime grid gives weights outside [0, 1] and the
stack extrapolates, as the JAX package's does.

* :func:`stack_batched` is the kernel wrapper: on CUDA tensors it
  launches ``csrc/gfstack.cu`` (or raises), on CPU tensors it runs the
  plain version.  ``.launches_multilinear`` and ``.launches_nearest``
  count K3's and K4's launches.
* :func:`plan_stack` picks the kernel variant and its tile sizes from the
  shapes: ``tiled`` (the cell tile of a patch in shared memory, serving a
  whole chain tile), ``gather`` (rows straight from the library) or, on a
  bfloat16 library, ``mma`` (the tiled block with its sums on the tensor
  cores).  ``.launches_mma`` counts the launches of ``mma``.
* :func:`stack_operands` hands the operands to the kernel as they come:
  ``(C, 1, P)`` onsets go with a target stride of 0, nothing is expanded
  or copied.
* :func:`stack_batched_reference` is the plain PyTorch version: the
  fancy gather of ``SeismicGFLibrary.stack_all`` in the JAX package,
  batched over chains and run in chain chunks so the gathered
  (chains, T, P, N) intermediate stays bounded.

The library keeps its natural (T, P, D, S, N) layout: a (d, s) cell is
one contiguous row of N samples, float32 or bfloat16 (the JAX package's
bf16 library, ``gfstack.py:71-80``).  A bfloat16 library is summed in
float32: ``tiled`` and ``gather`` widen its samples in registers, ``mma``
multiplies them on the tensor cores by each weight split into bfloat16 hi
+ lo (within 2⁻¹⁸ of the weight), the plain version widens them before its
products; the output and the other operands are float32 either way.
Neither op is differentiable (the JAX op has no VJP either).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache

import torch

from beat_tpu_torch.kernels.build import launch, load

#: elements of one gathered (chains, T, P, N) corner the plain version
#: holds at a time (1 GiB of float32)
_PLAIN_CHUNK_ELEMS = 2**28


def _clamp_cells(data, didx, sidx, multilinear: bool):
    """Cell indices clamped to the grid, int64: ceil indices in
    ``[1, D-1] × [1, S-1]`` for the multilinear corners, any cell for the
    nearest one — what ``durations2idxs``/``starttimes2idxs`` give."""
    _, _, D, S, _ = data.shape
    lo = 1 if multilinear else 0
    return didx.long().clamp(lo, D - 1), sidx.long().clamp(lo, S - 1)


def sum_dtype(data: torch.Tensor) -> torch.dtype:
    """The type a library's stack is summed and returned in: float32 for a
    bfloat16 library, the library's own otherwise."""
    return torch.float32 if data.dtype == torch.bfloat16 else data.dtype


def stack_batched_reference(data: torch.Tensor, didx: torch.Tensor, sidx: torch.Tensor,
                            slips: torch.Tensor, rtf: torch.Tensor | None = None,
                            stf: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch K3 (with ``rtf``/``stf``) or K4 (without): (C, T, N).

    Operands as :func:`stack_batched`; ``sidx``/``stf`` may be (C, 1, P).
    The gathered rows of a bfloat16 library are widened to float32."""
    T, P, D, S, N = data.shape
    C = didx.shape[0]
    multilinear = rtf is not None
    d, s = _clamp_cells(data, didx, sidx, multilinear)
    flat = data.reshape(T * P * D * S, N)
    tp = (torch.arange(T, device=data.device)[:, None] * P
          + torch.arange(P, device=data.device)[None, :])            # (T, P)
    out_dtype = sum_dtype(data)
    out = torch.empty((C, T, N), dtype=out_dtype, device=data.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(T * P * N, 1))
    for c0 in range(0, C, chunk):
        sl = slice(c0, c0 + chunk)
        d_c = d[sl, None, :]                                         # (c, 1, P)
        s_c = s[sl].expand(-1, T, -1)                                # (c, T, P)

        def cell(dd, ss):
            return flat[((tp * D + dd) * S + ss)].to(out_dtype)      # (c, T, P, N)

        if not multilinear:
            stacked = cell(d_c, s_c)
        else:
            rt_f = rtf[sl, None, :, None]
            st_f = stf[sl].expand(-1, T, -1)[..., None]
            stacked = (cell(d_c, s_c) * ((1 - st_f) * (1 - rt_f))
                       + cell(d_c, s_c - 1) * (st_f * (1 - rt_f))
                       + cell(d_c - 1, s_c) * ((1 - st_f) * rt_f)
                       + cell(d_c - 1, s_c - 1) * (st_f * rt_f))
        out[sl] = torch.einsum("ctpn,cp->ctn", stacked, slips[sl])
    return out


def _check(data, didx, sidx, slips, rtf, stf) -> None:
    if data.dim() != 5 or not data.is_contiguous() or not data.dtype.is_floating_point:
        raise ValueError(f"library must be a contiguous (T, P, D, S, N) float tensor, got "
                         f"{tuple(data.shape)} {data.dtype}")
    T, P, D, S, N = data.shape
    if (rtf is None) != (stf is None):
        raise ValueError("rtf and stf come together (multilinear) or not at all (nearest)")
    multilinear = rtf is not None
    if multilinear and (D < 2 or S < 2):
        raise ValueError(f"multilinear stacking needs >= 2 durations and starttimes, got "
                         f"{(D, S)}")
    C = didx.shape[0] if didx.dim() == 2 else -1
    per_patch = {"didx": didx, "slips": slips, "rtf": rtf}
    per_target = {"sidx": sidx, "stf": stf}
    if (any(x is not None and tuple(x.shape) != (C, P) for x in per_patch.values())
            or any(x is not None and (x.dim() != 3 or x.shape[0] != C
                                      or x.shape[1] not in (1, T) or x.shape[2] != P)
                   for x in per_target.values())):
        got = {k: tuple(x.shape) for k, x in {**per_patch, **per_target}.items()
               if x is not None}
        raise ValueError(f"need didx, slips (and rtf) of shape (C, {P}) and sidx (and stf) of "
                         f"shape (C, {T} or 1, {P}); got {got}")
    if didx.dtype.is_floating_point or sidx.dtype.is_floating_point:
        raise ValueError(f"didx and sidx must be integer, got {didx.dtype}, {sidx.dtype}")
    floats = [x for x in (slips, rtf, stf) if x is not None]
    if any(x.dtype != sum_dtype(data) for x in floats):
        raise ValueError(f"slips, rtf and stf must be {sum_dtype(data)} for a {data.dtype} "
                         f"library")
    if any(x.requires_grad for x in floats + [data]):
        raise NotImplementedError(
            "the GF stack is not differentiable (the JAX op has no VJP either): a backward "
            "kernel for K3 waits for a later port slice (ROADMAP: FFI gradient path)")
    devs = {x.device for x in (data, didx, sidx, slips) + tuple(floats)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    if data.device.type == "cpu":
        return
    if data.device.type != "cuda":
        raise ValueError(f"K3 and K4 run on CUDA (or their plain version on the CPU), not on "
                         f"{data.device}")
    if data.dtype not in _ENTRIES:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16 libraries, got "
                         f"{data.dtype}")
    if max(C, T, P, D, S, N) > 2**31 - 1:
        raise ValueError("a dimension exceeds the kernels' 32-bit sizes")


#: the C entries of K3 and K4 by library type: (multilinear, nearest)
_ENTRIES = {torch.float32: ("beat_gf_stack_multilinear_f32", "beat_gf_stack_nearest_f32"),
            torch.bfloat16: ("beat_gf_stack_multilinear_bf16", "beat_gf_stack_nearest_bf16")}

#: what one block of an H100 may use (``csrc/gfstack.cu`` checks the same)
SMEM_PER_BLOCK = 232_448        # bytes of shared memory
REGISTERS_PER_SM = 65_536       # 32-bit registers; the tiled variant runs one block an SM
#: the tiled variant's block (``kTiledThreads``, ``kChainsPerThread`` in
#: the source) and the threads along n that may serve one chain, by
#: preference; the n tile is 4 · lanes samples
_TILED_THREADS, _CHAINS_PER_THREAD, _TILED_LANES = 512, 16, (16, 8)
#: the tiled variant pays where a staged cell row serves enough row reads
#: of the chain tile (chains · corners / D·S).  On a long walk over the
#: patches the tile copies hide behind the sums and 1.5 reads a row are
#: enough (K4 at D·S = 320 serves 1.6); on a short walk the first copy and
#: fold lie open and it takes 6 (measured at the GF-stack bench shape and
#: the small FFI problem's: ``PERF.md`` §6).  Both are for float32 rows.
#: K4 on bfloat16 rows takes twice as many, since the gather variant's row
#: reads through L2 halve and the tiled variant's shared-memory reads do
#: not (at the Laquila shape on an H100: 1.69-1.73 ms ``gather`` against
#: 2.71-2.77 ms ``tiled`` at 1.6 reads a row).  K3 on bfloat16 rows is
#: planned by :data:`_BF16_K3_REUSE` instead.
_LONG_WALK_PATCHES, _ROW_REUSE_LONG_WALK, _ROW_REUSE_SHORT_WALK = 64, 1.5, 6.0
#: the gather variant's tile: chains a block, threads, patches of entries
_GATHER_CHAINS, _GATHER_THREADS, _GATHER_CHUNK = 8, 128, 32
#: the mma variant's block (``kMmaThreads``, ``kMmaNT``, ``kMmaCT``): its
#: n tile is 64 samples (8 chunks of 8, a 128-byte row of the cell tile),
#: its chain tile 512 chains, 64 float32 sums a thread, two cell tiles
_MMA_THREADS, _MMA_N_TILE, _MMA_CHAINS = 512, 64, 512
#: K3 on a bfloat16 library: ``mma`` (where it can run) from 3 reads a
#: staged cell row, else ``tiled`` from 1.5, on a long walk or a short one;
#: ``gather`` below.  Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W;
#: ``tools/bench_torch_stack_bf16.py``, the variants in turns; ``PERF.md``
#: §6), ms of ``mma`` / ``tiled`` / ``gather`` at (T, P, D, S, N) and C
#: chains (reads a row): the Laquila shape (12, 500, 10, 32, 512), 2000
#: (6.4): 3.90 / 4.51 / 6.30; the same library, 256 (3.2): 1.02 / 1.07 /
#: 1.42; 192 (2.4): 1.02 / 0.95 / 1.49; 128 (1.6): 0.92 / 0.83 / 1.57;
#: (12, 80, 10, 32, 512), 128 (1.6): 0.152 / 0.140 / 0.256; the short walk
#: (12, 40, 10, 32, 512), 2000 (6.4): 0.326 / 0.364 / 0.479; 512 (6.4):
#: 0.115 / 0.127 / 0.140; 256 (3.2): 0.090 / 0.093 / 0.122; 128 (1.6):
#: 0.079 / 0.079 / 0.131; (4, 40, 10, 32, 512), 2000: 0.110 / 0.125 / 0.226;
#: (12, 40, 5, 32, 512), 2000 (12.8): 0.304 / 0.344 / 0.444.  At a grid of
#: two blocks the three lie within 10 % and the rule is not the fastest:
#: (2, 11, 4, 9, 64), 37 (4.1): 0.059 / 0.054 / 0.056
_BF16_K3_REUSE = {"mma": 3.0, "tiled": 1.5}


@dataclass(frozen=True)
class StackPlan:
    """How one K3/K4 launch is cut, chosen from the shapes alone."""

    variant: str                # "tiled", "gather" or "mma"
    why: str                    # the reason for the variant
    threads: int                # threads of a block
    lanes: int                  # threads along n that serve one chain (tiled; else 0)
    chains_per_thread: int      # chains whose sums one thread keeps
    n_tile: int                 # samples of a block
    chain_tile: int             # chains of a block
    patch_chunk: int            # patches whose folded operands are staged at a time
    stages: int                 # cell-tile buffers in shared memory (tiled, mma; else 0)
    smem_bytes: int             # shared memory of a block
    sum_registers: int          # registers a thread spends on its sums
    grid: tuple                 # (chain tiles, n tiles, targets)

    @property
    def chunk_shift(self) -> int:
        return self.patch_chunk.bit_length() - 1


def _gather_plan(T, N, C, corners, why) -> StackPlan:
    vec = 4 if N % 4 == 0 else 1
    columns = -(-N // vec)
    threads = min(_GATHER_THREADS, -(-columns // 32) * 32)
    return StackPlan(
        "gather", why, threads, 0, _GATHER_CHAINS, threads * vec, _GATHER_CHAINS,
        _GATHER_CHUNK, 0, _GATHER_CHUNK * _GATHER_CHAINS * (8 + 4 * corners),
        _GATHER_CHAINS * vec, (-(-C // _GATHER_CHAINS), -(-columns // threads), T))


def _mma_plan(T, P, D, S, N, C, corners, aligned, elem_bytes) -> tuple:
    """``(plan, None)`` of the mma variant, or ``(None, why)`` where it
    cannot run."""
    if corners != 4:
        return None, "mma runs K3 only (K4's lost to gather: PERF.md §6)"
    if elem_bytes != 2:
        return None, "mma runs on bfloat16 libraries only"
    if N % 8 != 0 or not aligned:
        return None, "mma needs rows of 8-sample chunks on 16-byte boundaries (N % 8 != 0)"
    if min(T, P, C) < 1:
        return None, "nothing to stack"
    for chunk in (8, 4, 2, 1):
        smem = 2 * D * S * _MMA_N_TILE * 2 + _MMA_CHAINS * chunk * 16
        if smem <= SMEM_PER_BLOCK:
            return StackPlan(
                "mma", "", _MMA_THREADS, 0, 8, _MMA_N_TILE, _MMA_CHAINS, chunk, 2, smem, 64,
                (-(-C // _MMA_CHAINS), -(-N // _MMA_N_TILE), T)), None
    return None, (f"two bf16 cell tiles of D·S = {D * S} rows do not fit {SMEM_PER_BLOCK} "
                  f"bytes of shared memory")


@lru_cache(maxsize=256)
def plan_stack(T: int, P: int, D: int, S: int, N: int, C: int, corners: int = 4,
               variant: str | None = None, aligned: bool = True,
               elem_bytes: int = 4) -> StackPlan:
    """The variant and tile sizes of one K3 (``corners=4``) or K4
    (``corners=1``) launch on a (T, P, D, S, N) library of
    ``elem_bytes`` a sample (4 float32, 2 bfloat16) and C chains.

    ``tiled`` needs rows of aligned 4-sample columns (``N % 4 == 0``,
    ``aligned`` bases) and
    two (D·S × n tile) cell tiles plus a chunk of folded operands within
    :data:`SMEM_PER_BLOCK`; it is chosen where it pays: every staged
    cell row serves at least :data:`_ROW_REUSE_LONG_WALK` row reads of
    the chain tile over :data:`_LONG_WALK_PATCHES` patches or more, or
    :data:`_ROW_REUSE_SHORT_WALK` over fewer, times ``4 / elem_bytes``
    for K4 (K3 on bfloat16 rows: :data:`_BF16_K3_REUSE`).
    ``mma`` runs K3 on bfloat16 libraries only, with ``N % 8 == 0``,
    aligned bases and its two cell tiles within the same budget, and is
    chosen by :data:`_BF16_K3_REUSE`.
    Everything else takes
    ``gather``.  ``variant`` forces one (``ValueError`` where
    ``tiled`` or ``mma`` cannot run)."""
    if variant not in (None, "tiled", "gather", "mma"):
        raise ValueError(f"unknown variant {variant!r}")
    if variant == "gather":
        return _gather_plan(T, N, C, corners, "asked for")
    if variant == "mma" or (variant is None and elem_bytes == 2 and corners == 4):
        mma, why = _mma_plan(T, P, D, S, N, C, corners, aligned, elem_bytes)
        if variant == "mma":
            if mma is None:
                raise ValueError(f"the mma variant cannot run here: {why}")
            return dataclasses.replace(mma, why="asked for")
        reuse = min(C, _MMA_CHAINS) * corners / (D * S)
        if mma is not None and reuse >= _BF16_K3_REUSE["mma"]:
            return dataclasses.replace(
                mma, why=f"bf16 library; a staged cell row serves {reuse:.2f} reads of the "
                         f"chain tile over {P} patches")
    why = tile = None
    if N % 4 != 0 or not aligned:
        why = ("rows are not 16-byte (bfloat16: 8-byte) aligned (N % 4 != 0 or an "
               "unaligned base)")
    elif min(T, P, C) < 1:
        why = "nothing to stack"
    else:
        entry_bytes = 16 if corners == 4 else 8
        for lanes in _TILED_LANES:
            if lanes == 16 and N <= 32:
                continue                      # half of the n tile would be idle
            chain_tile = _TILED_THREADS // lanes * _CHAINS_PER_THREAD
            tiles_bytes = 2 * D * S * 4 * lanes * elem_bytes
            for chunk in (8, 4, 2, 1):
                smem = tiles_bytes + chain_tile * chunk * entry_bytes
                if smem <= SMEM_PER_BLOCK:
                    tile = (lanes, chain_tile, chunk, smem)
                    break
            if tile:
                break
        if tile is None:
            why = (f"two cell tiles of D·S = {D * S} rows do not fit {SMEM_PER_BLOCK} bytes "
                   f"of shared memory")
    if why is None and variant is None:
        reuse = min(C, tile[1]) * corners / (D * S)
        if corners == 4 and elem_bytes == 2:
            needed = _BF16_K3_REUSE["tiled"]
        else:
            needed = ((_ROW_REUSE_LONG_WALK if P >= _LONG_WALK_PATCHES
                       else _ROW_REUSE_SHORT_WALK) * 4 / elem_bytes)
        if reuse < needed:
            why = (f"a staged cell row would serve {reuse:.2f} reads of the chain tile over "
                   f"{P} patches")
    if why is not None:
        if variant == "tiled":
            raise ValueError(f"the tiled variant cannot run here: {why}")
        return _gather_plan(T, N, C, corners, why)
    lanes, chain_tile, chunk, smem = tile
    return StackPlan(
        "tiled", "asked for" if variant else "cell tiles fit and are reused", _TILED_THREADS,
        lanes, _CHAINS_PER_THREAD, 4 * lanes, chain_tile, chunk, 2, smem,
        4 * _CHAINS_PER_THREAD, (-(-C // chain_tile), -(-N // (4 * lanes)), T))


def group_cells(didx: torch.Tensor, sidx: torch.Tensor, group: int = 8) -> dict:
    """How many distinct cells the ``mma`` variant's groups of ``group``
    chains read at one (target, patch) of K3: the mean and max over the
    operands' whole groups beside the ``4 · group`` rows a group's
    product takes.  Compacting a group's rows to its distinct cells would
    save the difference; ``didx`` (C, P), ``sidx`` (C, T or 1, P) clamped
    to the grid as the kernel clamps them (:func:`_clamp_cells`)."""
    C, T, P = sidx.shape[0], sidx.shape[1], didx.shape[1]
    d = didx.long()[:, None, :].expand(C, T, P)
    s = sidx.long().expand(C, T, P)
    wide = 2 * int(s.abs().max()) + 4             # a cell's code: d · wide + s, distinct
    cells = torch.stack([(d - dd) * wide + (s - ss)
                         for dd, ss in ((1, 1), (1, 0), (0, 1), (0, 0))], -1)
    whole = C // group * group
    if whole == 0:
        return {"rows": 4 * group, "mean": float("nan"), "max": 0}
    cells = cells[:whole].reshape(whole // group, group, T, P, 4)
    srt = cells.permute(0, 2, 3, 1, 4).reshape(-1, 4 * group).sort(-1).values
    distinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(-1)
    return {"rows": 4 * group, "mean": float(distinct.float().mean()),
            "max": int(distinct.max())}


def stack_operands(didx, sidx, slips, rtf=None, stf=None) -> tuple:
    """The operands as the kernels address them: ``(tensors, strides)``
    with ``tensors = (didx, sidx, slips[, rtf, stf])`` and ``strides``
    the chain strides (and, for ``sidx`` and ``stf``, the target
    strides) in elements, in the C entries' order.  ``int32`` indices
    and floats with unit stride along the patches pass as they are; a
    ``(C, 1, P)`` ``sidx``/``stf`` gets a target stride of 0.  Other
    index types and layouts are converted (a copy)."""
    def unit(x):
        return x if x.stride(-1) == 1 or x.shape[-1] <= 1 else x.contiguous()

    def i32(x):
        return unit(x if x.dtype == torch.int32 else x.to(torch.int32))

    def t_stride(x):
        return 0 if x.shape[1] == 1 else x.stride(1)

    didx, sidx, slips = i32(didx), i32(sidx), unit(slips)
    if rtf is None:
        return ((didx, sidx, slips),
                (didx.stride(0), sidx.stride(0), t_stride(sidx), slips.stride(0)))
    rtf, stf = unit(rtf), unit(stf)
    return ((didx, sidx, slips, rtf, stf),
            (didx.stride(0), sidx.stride(0), t_stride(sidx), slips.stride(0),
             rtf.stride(0), stf.stride(0), t_stride(stf)))


#: the C entries' ``variant`` argument
_VARIANT_CODES = {"gather": 0, "tiled": 1, "mma": 2}


def _launch(data, didx, sidx, slips, rtf, stf, plan: StackPlan) -> torch.Tensor:
    """One K3 or K4 launch on checked operands, on the current stream."""
    lib, _ = load("gfstack")
    T, P, D, S, N = data.shape
    C = didx.shape[0]
    tensors, strides = stack_operands(didx, sidx, slips, rtf, stf)
    out = torch.empty((C, T, N), dtype=torch.float32, device=data.device)
    multilinear, nearest = _ENTRIES[data.dtype]
    entry = getattr(lib, nearest if rtf is None else multilinear)
    rc = launch(data.device, entry, data.data_ptr(), *(x.data_ptr() for x in tensors),
                out.data_ptr(), C, T, P, D, S, N, *strides, _VARIANT_CODES[plan.variant],
                plan.lanes, plan.chunk_shift)
    if rc != 0:
        raise RuntimeError(f"GF stack kernel launch failed ({plan.variant}): cudaError {rc}")
    return out


def stack_batched(data: torch.Tensor, didx: torch.Tensor, sidx: torch.Tensor,
                  slips: torch.Tensor, rtf: torch.Tensor | None = None,
                  stf: torch.Tensor | None = None, variant: str | None = None) -> torch.Tensor:
    """K3 (with ``rtf`` and ``stf``) or K4 (without): the all-chain
    kinematic stack.

    data : (T, P, D, S, N) float32 or bfloat16, contiguous — the library.
    didx : (C, P) integer duration indices (ceil index for K3).
    sidx : (C, T, P) integer starttime indices, or (C, 1, P) when every
        target sees the same onsets.
    slips : (C, P) float32 (the library's type for a float64 one on the CPU).
    rtf, stf : floor-cell weights, (C, P) and shaped like ``sidx``.
    Indices are clamped to the grid; the weights are used as given.
    variant : ``None`` lets :func:`plan_stack` choose the kernel variant
        from the shapes; ``"tiled"``, ``"gather"`` or (bfloat16 libraries)
        ``"mma"`` asks for one (``tiled`` and ``gather`` are equal bit for
        bit; ``mma`` sums in another order, deterministically).

    Returns (C, T, N) float32 (float64 for a float64 library on the CPU).
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    and any failure raises."""
    _check(data, didx, sidx, slips, rtf, stf)
    if data.device.type == "cpu":
        return stack_batched_reference(data, didx, sidx, slips, rtf, stf)
    if didx.shape[0] == 0 or data.shape[0] == 0 or data.shape[4] == 0:
        return torch.empty((didx.shape[0], data.shape[0], data.shape[4]),
                           dtype=torch.float32, device=data.device)
    T, P, D, S, N = data.shape
    plan = plan_stack(T, P, D, S, N, didx.shape[0], corners=1 if rtf is None else 4,
                      variant=variant, aligned=data.data_ptr() % 16 == 0,
                      elem_bytes=data.element_size())
    out = _launch(data, didx, sidx, slips, rtf, stf, plan)
    if rtf is not None:
        stack_batched.launches_multilinear += 1
    else:
        stack_batched.launches_nearest += 1
    if data.dtype == torch.bfloat16:
        stack_batched.launches_bf16 += 1
    if plan.variant == "mma":
        stack_batched.launches_mma += 1
    return out


#: K3's and K4's launches; those on a bfloat16 library are counted in
#: ``launches_bf16`` as well, those of the mma variant in ``launches_mma``
stack_batched.launches_multilinear = 0
stack_batched.launches_nearest = 0
stack_batched.launches_bf16 = 0
stack_batched.launches_mma = 0
