"""Fused STFT analysis and iSTFT synthesis: kernels A, B (forward), D, E (backward).

Counterparts of signaltrain_tpu/ops/pallas_frontend.py. Each kernel is
hand-written CUDA C++ for Hopper: A and B in ``csrc/frontend.cu``, D and E in
``csrc/frontend_bwd.cu`` (the headers say what bounds each on the card and
how its design answers that); their products run on two tensor-core
schedules, ``csrc/tc_product.cuh``'s ``mma.sync`` loop and
``csrc/wgmma_product.cuh``, both of which form every f32 product from three
TF32 ones (``split_tf32_matmul`` below is that arithmetic in plain PyTorch,
for the tests and reports; nothing on the main path calls it). This
module holds the wrappers, the plain PyTorch version of every kernel, the two
``torch.autograd.Function``s and the weight stacking.

* ``fused_analysis(xp, w, ft, hop)``: padded signal (B, Lp), NOT pre-halved
  (the kernel applies the model's x/2) -> (mag, phs), each (T, B, half),
  frame-major, with T = (Lp - ft)//hop + 1.
* ``fused_synthesis(mag, phs, w, ft, hop)``: frame-major (OT, B, half)
  magnitude/phase -> trimmed waveform (B, (OT-1)*hop - ft).

Both differentiate: forward is kernel A / B, backward kernel D / E, saving
only (xp, w) and (mag, phs, w) and recomputing the rest.

Each takes ``compute_dtype``, the JAX kernels' argument: ``torch.float32``
(split-TF32 products, as accurate as float32) or ``torch.bfloat16``, where
exactly the operands that the JAX kernels cast are rounded to bf16 (to
nearest even) and multiplied with float32 accumulation: A's halved frame and
weights, B's spectrum and weights, D's halved frame, weights and dspec, E's
padded dframe, weights and spectrum. Inputs, outputs and everything else
(magnitude, phase, trig, overlap-add) stay float32. Each mode has its own
launch counter (``bf16_*`` for bfloat16).

* ``fused_analysis_bwd(xp, w, dmag, dphs, ft, hop)`` -> (dxp, dw).
* ``fused_synthesis_bwd(mag, phs, w, dout, ft, hop)`` -> (dmag, dphs, dw).

Each of the four has two schedules in each compute dtype (``SCHEDULES``):
"wgmma" (``csrc/wgmma_product.cuh``: TMA into a ring of shared-memory
stages, wgmma, no K slices; in float32 split TF32 with A's fragments split
in registers and B's operand in pre-split planes) and "mma" (the
``mma.sync`` loop of ``csrc/tc_product.cuh``). The wrapper picks by a rule
on the shape (``schedule_for``): for A, D and E, which read frames through
TMA, "wgmma" where every frame offset and length is a multiple of 16 bytes
(``uses_wgmma``; in float32 A and D also a 16-byte aligned signal, which TMA
reads as it is), "mma" elsewhere; for B, which reads none, "wgmma" at every
shape. ``schedule=`` names one for the tests and timers. Each schedule has
its own launch counter (``..._mma`` for the mma.sync one). A schedule that
cannot take the shape, or fails to build or launch, raises; nothing retries
on the other one.

All four are bound by operations (f32-accurate matrix products). On the
mma.sync loop a product whose output has too few tiles to fill the card (dW
of D and E, B's frames, E's dspec) has its K cut into a fixed number of
contiguous slices (``k_slices``), each output tile of a slice owned by one
block, and the slices are added in a fixed order by the pass that follows
(the wgmma schedule cuts no K: its tiles fill the card): no atomics, so
every result is bit-equal from run to run. The overlap-add of dxp (D) and of
the waveform (B) is a gather: each sample is owned by one thread that sums
the frames covering it. B and E work on the live frames only (1 .. OT-2, the
ones with samples inside the trimmed output).

One dispatch rule everywhere: a CPU tensor goes to the plain version, a CUDA
tensor launches the kernel or raises. Nothing gives way to a plain version on
the card.

Weight layouts: analysis (ft, 2*half), column c < half is bin c of the real
part and column half + c bin c of the imaginary part; synthesis (2*half, ft),
rows in the same order, with the conjugate mirror folded in
(``frontend.fold_synthesis_weights``). Unlike the TPU layout there is no
128-lane padding. The gradient of a stacked operand flows back to the
(ft, ft) parameters through the stacking and folding by plain autograd.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _cuda, framing

ANALYSIS = _cuda.counter("fused_analysis")  # float32 A: the wgmma schedule
SYNTHESIS = _cuda.counter("fused_synthesis")  # float32 B: the wgmma schedule
ANALYSIS_BWD = _cuda.counter("fused_analysis_bwd")  # float32 D: the wgmma schedule
SYNTHESIS_BWD = _cuda.counter("fused_synthesis_bwd")  # float32 E: the wgmma schedule
ANALYSIS_MMA = _cuda.counter("fused_analysis_mma")
SYNTHESIS_MMA = _cuda.counter("fused_synthesis_mma")
ANALYSIS_BWD_MMA = _cuda.counter("fused_analysis_bwd_mma")
SYNTHESIS_BWD_MMA = _cuda.counter("fused_synthesis_bwd_mma")
ANALYSIS_BF16 = _cuda.counter("bf16_fused_analysis")  # the wgmma schedule
SYNTHESIS_BF16 = _cuda.counter("bf16_fused_synthesis")  # the wgmma schedule
ANALYSIS_BF16_MMA = _cuda.counter("bf16_fused_analysis_mma")
SYNTHESIS_BF16_MMA = _cuda.counter("bf16_fused_synthesis_mma")
ANALYSIS_BWD_BF16 = _cuda.counter("bf16_fused_analysis_bwd")  # the wgmma schedule
SYNTHESIS_BWD_BF16 = _cuda.counter("bf16_fused_synthesis_bwd")  # the wgmma schedule
ANALYSIS_BWD_BF16_MMA = _cuda.counter("bf16_fused_analysis_bwd_mma")
SYNTHESIS_BWD_BF16_MMA = _cuda.counter("bf16_fused_synthesis_bwd_mma")
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
SCHEDULES = ("wgmma", "mma")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ANALYSIS_ARGS = [_P] * 6 + [_I] * 8 + [_P]
_SYNTHESIS_ARGS = [_P] * 7 + [_I] * 9 + [_P]
_ANALYSIS_WGMMA_ARGS = [_P] * 6 + [_I] * 6 + [_P]
_SYNTHESIS_WGMMA_ARGS = [_P] * 7 + [_I] * 6 + [_P]
_ANALYSIS_BWD_ARGS = [_P] * 11 + [_I] * 11 + [_P]
_SYNTHESIS_BWD_ARGS = [_P] * 12 + [_I] * 11 + [_P]
_ANALYSIS_BWD_WGMMA_ARGS = [_P] * 10 + [_I] * 8 + [_P]
_ANALYSIS_WGMMA_F32_ARGS = [_P] * 6 + [_I] * 6 + [_P]
_ANALYSIS_BWD_WGMMA_F32_ARGS = [_P] * 14 + [_I] * 8 + [_P]
_SYNTHESIS_BWD_WGMMA_ARGS = [_P] * 10 + [_I] * 7 + [_P]
_SYNTHESIS_WGMMA_F32_ARGS = [_P] * 8 + [_I] * 6 + [_P]
_SYNTHESIS_BWD_WGMMA_F32_ARGS = [_P] * 12 + [_I] * 7 + [_P]


def _counters(f32: _cuda.KernelCounter, bf16: _cuda.KernelCounter, compute_dtype: torch.dtype):
    """The counter of the kernel mode that compute_dtype selects."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
    return bf16 if compute_dtype == torch.bfloat16 else f32

# A product whose (m x n) output has too few tiles to fill the card has its K
# cut into slices (a fixed number for given shapes) whose partial sums the pass
# that follows adds in order. The tensor-core product (128 x 128 tiles, K step
# 32, two blocks of 110 KB shared memory an SM) takes as many slices as keep
# every full-width block on the card's 132 SMs at once (a second round of a few
# blocks would cost as much as a full one), and at least 8 K steps a slice; the
# blocks of a narrow last column tile are cheap and not counted.
_RESIDENT_BLOCKS = 2 * 132
_TILE = 128
_KSTEP = 32


def k_slices(m: int, n: int, k: int) -> int:
    """How many K slices the tensor-core product of an (m, n) output over K = k
    takes: kernel D's and E's dW, B's frames and E's dspec."""
    tiles = -(-m // _TILE) * max(1, n // _TILE)
    return max(1, min(_RESIDENT_BLOCKS // tiles, -(-k // _KSTEP) // 8))


def _wide(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in 16 bytes: 4 floats, 8 bf16."""
    return 16 // dtype.itemsize


def packed_width(half: int, dtype: torch.dtype = torch.float32) -> int:
    """Columns of the repacked weights and of the interleaved spectra (re and
    im of a bin side by side) in the operand type ``dtype``: 2*half rounded up
    to a multiple of 16 bytes (4 floats, 8 bf16), so every row starts on 16
    bytes."""
    wide = _wide(dtype)
    return -(-2 * half // wide) * wide


def copy_width(ft: int, hop: int, lp: int, *tensors: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> int:
    """Elements per copy of the tensor-core products with operands of type
    ``dtype``: 16 bytes' worth (4 floats, 8 bf16) when the frame offsets
    b*lp + t*hop, the frame length and every pointer are multiples of 16
    bytes, else 1. Two loaders of the same kernel. Kernel B's operands are
    rows of packed_width elements: only its pointers count."""
    wide = _wide(dtype)
    aligned = ft % wide == 0 and hop % wide == 0 and lp % wide == 0
    return wide if aligned and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def uses_wgmma(ft: int, hop: int, lp: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """The rule that picks the schedule of kernels A, D and E: "wgmma" when
    the frames can be read by TMA, i.e. when ft, hop and the padded row
    length lp are multiples of 16 bytes of the operand type ``dtype`` (8
    bf16, 4 floats), else "mma". In bf16 TMA reads only the launch's own
    scratch (the halved or padded signal, the packed weights, dspec, E's
    spectrum), which the allocator aligns, so no pointer enters the rule; in
    float32 A and D read the signal itself, whose alignment ``schedule_for``
    takes as ``aligned``. The flagship geometry (1024, 384,
    10240) takes wgmma; the tests' "ragged" one (hop 30) cannot.

    Kernel B reads no frames through TMA: its two TMA operands are the
    spectrum of the live frames (rows, ldc) and the packed weights (ft, ldc)
    (in float32 the weights' split planes), rows of ``packed_width``
    elements, a multiple of 16 bytes for every half, and its epilogue writes
    the frames (rows, ft) in float32 at any ft. So B's rule (``schedule_for``
    with ``lp=None``) takes wgmma at every geometry in both dtypes, the
    "ragged" one included. Kernel E reads the frames of its own scratch
    (the padded dout), so no pointer enters its rule in either dtype."""
    wide = _wide(dtype)
    return ft % wide == 0 and hop % wide == 0 and lp % wide == 0


# the kernels whose float32 mode has a wgmma schedule
F32_WGMMA_KERNELS = ("A", "B", "D", "E")


def schedule_for(schedule: str | None, compute_dtype: torch.dtype, ft: int, hop: int,
                 lp: int | None, kernel: str | None = None, aligned: bool = True) -> str:
    """The schedule of a launch of A, B, D or E: ``schedule`` if given (one of
    ``SCHEDULES``), else the rule's. "wgmma" for the kernels that read
    frames of a row of length ``lp`` through TMA (A, D, E) where
    ``uses_wgmma`` holds for the compute dtype's elements, and for B
    (``lp=None``: it reads none) at every shape. In float32 the ``kernel``
    must be named (one of ``F32_WGMMA_KERNELS``), and A's and D's signal,
    which TMA reads as it is, must be 16-byte ``aligned``; E's frames are its
    own scratch. Raises on anything else, a "wgmma" the rule cannot give
    included."""
    if schedule is not None and schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES} or None, got {schedule!r}")
    if compute_dtype == torch.bfloat16:
        wgmma_ok = lp is None or uses_wgmma(ft, hop, lp)
    elif kernel == "B":  # float32 B reads no frames: every shape, as in bf16
        wgmma_ok = lp is None
    else:  # float32 A and D read the signal itself, E its own padded dout
        wgmma_ok = (kernel in F32_WGMMA_KERNELS and lp is not None
                    and (aligned or kernel == "E") and uses_wgmma(ft, hop, lp, torch.float32))
    if schedule == "wgmma" and not wgmma_ok:
        raise ValueError(f"the wgmma schedule takes bf16, or float32 in kernels "
                         f"{F32_WGMMA_KERNELS} (A and D with an aligned signal), and 16-byte "
                         f"frames (ft={ft}, hop={hop}, lp={lp}, compute_dtype={compute_dtype}, "
                         f"kernel={kernel}, aligned={aligned})")
    return schedule or ("wgmma" if wgmma_ok else "mma")


def aligned_16(t: torch.Tensor) -> bool:
    """Whether t's data starts on a 16-byte boundary (what TMA needs of a
    tensor it reads as it is: float32 A's and D's signal)."""
    return t.data_ptr() % 16 == 0


def pad_rows(batch: int) -> int:
    """The wgmma schedule's rows a frame: batch rounded up to 8 (a TMA box of
    8 windows, csrc/wgmma_product.cuh)."""
    return -(-batch // 8) * 8


def analysis_fwd_scratch(compute_dtype: torch.dtype, b: int, lp: int, ft: int, half: int,
                         schedule: str = "mma") -> dict:
    """The scratch tensors kernel A's launch takes, name -> (shape, dtype), in
    the launcher's order (None: not needed): the halved and rounded signal in
    bf16 and the packed weights, the same on either bf16 schedule (A's
    product has enough tiles on both, so neither cuts K into slices); in
    float32 on the wgmma schedule the split planes of the packed weights'
    transpose (ldc, ft) instead."""
    op = compute_dtype
    if op == torch.float32 and schedule == "wgmma":
        wt = ((packed_width(half), ft), op)
        return {"wt_hi": wt, "wt_lo": wt}
    return {"xq": ((b, lp), op) if op == torch.bfloat16 else None,
            "wp": ((ft, packed_width(half, op)), op)}


def synthesis_fwd_scratch(schedule: str, compute_dtype: torch.dtype, b: int, ot: int, ft: int,
                          half: int) -> dict:
    """The scratch tensors kernel B's launch takes, name -> (shape, dtype), in
    the launcher's order: the packed weights (in float32 on the wgmma
    schedule their split planes hi, lo), the spectrum of the live frames and
    their samples in float32, in K slices (``k_slices``) on the mma schedule,
    written once on the wgmma one."""
    op, f32 = compute_dtype, torch.float32
    ldc, rows = packed_width(half, op), max(0, ot - 2) * b
    frames = (rows, ft) if schedule == "wgmma" else (k_slices(rows, ft, ldc), rows, ft)
    wp = {"wp_hi": ((ft, ldc), f32), "wp_lo": ((ft, ldc), f32)} if (
        schedule == "wgmma" and op == f32) else {"wp": ((ft, ldc), op)}
    return {**wp, "spec": ((rows, ldc), op), "frames": (frames, f32)}


def analysis_bwd_scratch(schedule: str, compute_dtype: torch.dtype, b: int, lp: int, ft: int,
                         half: int, t: int, need_dxp: bool, need_dw: bool) -> dict:
    """The scratch tensors kernel D's launch takes, name -> (shape, dtype), in
    the launcher's order (None: not needed). The mma schedule's f32 K-slice
    partials of dW and the wgmma schedule's padded dspec rows are the
    difference; in float32 the wgmma schedule takes the split planes of its
    B operands."""
    op, f32 = compute_dtype, torch.float32
    ldc = packed_width(half, compute_dtype)
    bf16 = compute_dtype == torch.bfloat16
    if schedule == "wgmma" and not bf16:
        # split TF32: W^T's planes for the spectrum, W's for dxp's frame
        # product, dspec in rows for dxp, its transpose's planes for dW
        rows = t * pad_rows(b)
        wt, wp, dspect = ((ldc, ft), f32), ((ft, ldc), f32), ((ldc, rows), f32)
        return {"wt_hi": wt, "wt_lo": wt, "wp_hi": wp if need_dxp else None,
                "wp_lo": wp if need_dxp else None,
                "dspec": ((rows, ldc), f32) if need_dxp else None,
                "dspect_hi": dspect if need_dw else None, "dspect_lo": dspect if need_dw else None,
                "dframes": ((t * b, ft), f32) if need_dxp else None}
    if schedule == "wgmma":
        return {"xq": ((b, lp), op), "wp": ((ft, ldc), op), "dspec": ((t * pad_rows(b), ldc), op),
                "dframes": ((t * b, ft), f32) if need_dxp else None}
    return {"xq": ((b, lp), op) if bf16 else None, "wp": ((ft, ldc), op),
            "dspec": ((t * b, ldc), op),
            "dw_partial": ((k_slices(ft, ldc, t * b), ft, ldc), f32) if need_dw else None,
            "dframes": ((t * b, ft), f32) if need_dxp else None}


def synthesis_bwd_scratch(schedule: str, compute_dtype: torch.dtype, b: int, ot: int, ft: int,
                          half: int, out_len: int, need_dw: bool) -> dict:
    """The scratch tensors kernel E's launch takes, name -> (shape, dtype), in
    the launcher's order (None: not needed): the mma schedule's f32 K-slice
    partials of dspec and dW against the wgmma schedule's none; in float32
    the wgmma schedule takes the split planes of its B operands, the
    synthesis weights' (ldc, ft) and the spectrum's transpose (ldc, rows)."""
    op, f32 = compute_dtype, torch.float32
    ldc, rows, lp = packed_width(half, compute_dtype), max(0, ot - 2) * b, out_len + 2 * ft
    if schedule == "wgmma" and op == f32:
        wt, spect = ((ldc, ft), f32), ((ldc, max(0, ot - 2) * pad_rows(b)), f32)
        return {"wt_hi": wt, "wt_lo": wt, "doutp": ((b, lp), f32),
                "spect_hi": spect if need_dw else None, "spect_lo": spect if need_dw else None}
    if schedule == "wgmma":
        return {"wp": ((ft, ldc), op), "doutp": ((b, lp), op),
                "spec": ((max(0, ot - 2) * pad_rows(b), ldc), op) if need_dw else None}
    return {"wp": ((ft, ldc), op), "doutp": ((b, lp), op),
            "dspec": ((k_slices(rows, ldc, ft), rows, ldc), f32),
            "spec": ((rows, ldc), op) if need_dw else None,
            "dw_partial": ((k_slices(ft, ldc, rows), ft, ldc), f32) if need_dw else None}


def _scratch(spec: dict, dev: torch.device) -> dict:
    return {k: None if v is None else torch.empty(v[0], device=dev, dtype=v[1])
            for k, v in spec.items()}


def round_operand(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """x as a product's operand of the compute dtype sees it, in x's own
    dtype: unchanged for float32, rounded to bf16 (to nearest even, as JAX's
    ``astype`` rounds) and back for bfloat16. The plain versions' one
    rounding rule."""
    if compute_dtype == torch.bfloat16:
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def stack_analysis_weights(w_real: torch.Tensor, w_imag: torch.Tensor, half: int) -> torch.Tensor:
    """(ft, ft) real and imaginary analysis matrices (rows are bins) ->
    (ft, 2*half) kernel operand. Rows >= half of the parameters are unused,
    as after the reference's post-conv slice."""
    return torch.cat([w_real[:half], w_imag[:half]], dim=0).t().contiguous()


def stack_synthesis_weights(wr_eff: torch.Tensor, wi_eff: torch.Tensor) -> torch.Tensor:
    """Folded (half, ft) synthesis matrices -> (2*half, ft) kernel operand."""
    return torch.cat([wr_eff, wi_eff], dim=0).contiguous()


def mag_phs(re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Magnitude with the 1e-36 floor (edge frames that cover only padding
    give exactly 1e-18 and a zero gradient) and phase atan2(im, re + 1e-7)."""
    mag = torch.sqrt(torch.clamp_min(re * re + im * im, 1e-36))
    phs = torch.atan2(im, re + 1e-7)
    return mag, phs


# ------------------------------------- the kernels' arithmetic, in plain torch

def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (float32) -> (hi, lo), both TF32 values held in float32: hi is x
    rounded to 10 mantissa bits as ``cvt.rna.tf32.f32`` rounds (to nearest,
    ties away from zero: ``(bits + 0x1000) & ~0x1FFF``), lo is x - hi cut to
    10 mantissa bits (the tensor core ignores the low 13 bits of an operand).
    hi + lo recovers x to 2^-21 |x|; zeros split into zeros."""
    hi = ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
    """a @ b as kernels A, B, D and E form it on the tensor cores: three products
    of TF32 operands summed in float32, the small terms first. ``chunk``: K
    cut into chunks of that many, each chunk's three products summed from
    zero and the chunks joined in order by float32 (round-to-nearest) adds,
    as the kernels join a chunk to their sums (the mma.sync loop's chunks are
    8, the wgmma schedule's 32, one K step); None: K in one chunk. Not used
    on the main path: the tests and ``chip_smoke.py`` hold the kernels'
    accuracy against it."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    k = a.shape[-1]
    out = None
    for k0 in range(0, k, chunk or max(k, 1)):
        sa, sb = (..., slice(k0, k0 + (chunk or k))), slice(k0, k0 + (chunk or k))
        part = ((torch.matmul(a_lo[sa], b_hi[sb]) + torch.matmul(a_hi[sa], b_lo[sb]))
                + torch.matmul(a_hi[sa], b_hi[sb]))
        out = part if out is None else out + part
    return out


def interleave(w: torch.Tensor, width: int) -> torch.Tensor:
    """(..., 2*half) stacked as [re | im] -> (..., width) with re and im of a
    bin side by side (column 2*bin + part) and zeros past 2*half: the layout
    of the kernels' packed weights and spectra."""
    half = w.shape[-1] // 2
    out = w.new_zeros(*w.shape[:-1], width)
    out[..., 0 : 2 * half : 2] = w[..., :half]
    out[..., 1 : 2 * half : 2] = w[..., half:]
    return out


def pack_split_reference(w: torch.Tensor, transposed: bool = False):
    """Plain version of the weight repacks of the float32 wgmma schedule
    (csrc/tc_product.cuh ``pack_split`` and ``pack_split_transposed``): the
    stacked analysis weights (ft, 2*half) interleaved into (ft, ldc) (K the
    column, kernel D's frame product), or its transpose (ldc, ft) (K the
    frame sample, the spectrum product of A and D), as the two planes
    ``split_tf32`` cuts: (hi, lo). TF32 wgmma reads its shared-memory
    operand K-major only, so the kernels read each plane as it lies."""
    wp = interleave(w, packed_width(w.shape[-1] // 2))
    return split_tf32(wp.t().contiguous() if transposed else wp)


def pack_split_synthesis_reference(w: torch.Tensor, transposed: bool = False):
    """Plain version of csrc/tc_product.cuh ``pack_split_synthesis``: the
    stacked synthesis weights (2*half, ft) packed as kernel B reads them,
    (ft, ldc) with column 2*bin + part = row part*half + bin (K the column,
    B's frame product), or its transpose (ldc, ft), w's rows interleaved (K
    the frame sample, E's dspec product), as the two planes ``split_tf32``
    cuts: (hi, lo), zero past 2*half."""
    wp = interleave(w.t(), packed_width(w.shape[0] // 2))
    return split_tf32(wp.t().contiguous() if transposed else wp)


def fused_analysis_bwd_conditioning(xp: torch.Tensor, w: torch.Tensor, dmag: torch.Tensor,
                                    dphs: torch.Tensor, ft: int, hop: int,
                                    sigma: float = 5e-7, k: float = 6.0):
    """How far kernel D's (dxp, dw) move, element by element, when every
    component of the recomputed spectrum moves at random by ``sigma``, as
    ``k`` standard deviations, in float64: (dxp_slack, dw_slack). Two f32
    spectra differ by up to ~1e-6 (the order of the sums; sigma is the largest
    error of an f32 product against a float64 one seen on the CPU), and the
    adjoints divide by the magnitude: with r = |spec|, d(re/r) <= 1/r and
    d(im/(rr^2 + im^2)) = 1/r^2 per unit, so dspec moves by
    sigma*(|dmag|/r + |dphs|/r^2), taken at r - k*sigma. That is pushed through
    the two linear products in quadrature (independent errors). It is huge on
    bins of near-zero magnitude (nothing can be said there) and exactly 0
    where the frame is all padding. Not used on the main path: the tests and
    ``chip_smoke.py`` add it to the tolerance of D's ill-conditioned case."""
    half = w.shape[1] // 2
    frames = framing.frame_signal(xp.double(), ft, hop, pad=0).transpose(0, 1) * 0.5
    w = w.double()
    spec = torch.matmul(frames, w)
    re, im = spec[..., :half], spec[..., half:]
    r = torch.sqrt(re * re + im * im)
    r_near = torch.clamp_min(r - k * sigma, 1e-30)
    moved = sigma * (dmag.double().abs() / r_near + dphs.double().abs() / (r_near * r_near))
    moved = torch.where(r > 0, moved, torch.zeros_like(moved))  # an exact 0 stays exact
    var = torch.cat([moved, moved], dim=-1) ** 2
    dxp = framing.overlap_add((torch.matmul(var, (w * w).t()) * 0.25).transpose(0, 1), hop)
    dxp = F.pad(dxp, (0, xp.shape[1] - dxp.shape[1]))
    dw = torch.matmul((frames * frames).reshape(-1, ft).t(), var.reshape(-1, 2 * half))
    return k * torch.sqrt(dxp), k * torch.sqrt(dw)


# How far the f32 spectrum that bf16 D forms again lies from float64, as a
# share of the spectrum's largest component (its error is much the same on
# every bin and scales with the frames and weights), as
# cli/time_frontend.spectrum_error reads it on an NVIDIA H100 at the flagship
# geometry (batches 200 and 643, two sets of inputs): root mean square over
# the components 1.6e-8 on the wgmma schedule, 2.4e-8 on the mma.sync one,
# the largest 2.4e-7 and 4.0e-7. FLIP_SIGMA is the larger root mean square
# rounded up, FLIP_K * FLIP_SIGMA lies half over the largest; chip_smoke.py
# holds both schedules to them on every run.
FLIP_SIGMA = 3e-8
FLIP_K = 20.0


def fused_analysis_bwd_flip_slack(xp: torch.Tensor, w: torch.Tensor, dmag: torch.Tensor,
                                  dphs: torch.Tensor, ft: int, hop: int):
    """The bf16 counterpart of ``fused_analysis_bwd_conditioning``: how far
    kernel D's bf16 (dxp, dw) move, element by element, as k = ``FLIP_K``
    standard deviations in float64, when the spectrum is formed in another
    order, each component off float64's by sigma = ``FLIP_SIGMA`` times the
    spectrum's largest component.
    bf16 D rounds dspec once; a spectrum component that moves by sigma moves
    dspec's float32 value by moved = sigma * (|dmag|/r + |dphs|/r^2) (taken
    at r - k*sigma), which flips its rounding with a chance of about
    moved / ulp, the flip moving it by one bf16 ulp (2^-8 relative, of the
    float64 dspec's binade), or moves it by about moved where moved >= ulp:
    a variance of moved * max(moved, ulp) an element of dspec, pushed
    through the two products (the bf16-rounded frames and weights) in
    quadrature. It is large on the near-zero bins, whose dspec (the phase
    adjoint) is large, and exactly 0 where the frame is all padding.
    Returns (dxp_slack, dw_slack). Not used on the main path: the tests and
    ``chip_smoke.py`` subtract it from bf16 D's error before the float64
    rule."""
    bf16, k = torch.bfloat16, FLIP_K
    half = w.shape[1] // 2
    frames = framing.frame_signal(xp.double(), ft, hop, pad=0).transpose(0, 1) * 0.5
    frames, w = round_operand(frames, bf16), round_operand(w.double(), bf16)
    spec = torch.matmul(frames, w)
    sigma = FLIP_SIGMA * float(spec.abs().max())
    re, im = spec[..., :half], spec[..., half:]
    sq = re * re + im * im
    r = torch.sqrt(sq)
    r_near = torch.clamp_min(r - k * sigma, 1e-30)
    dmag, dphs = dmag.double(), dphs.double()
    moved = sigma * (dmag.abs() / r_near + dphs.abs() / (r_near * r_near))
    moved = torch.where(r > 0, moved, torch.zeros_like(moved))  # an exact 0 stays exact
    gm = torch.where(sq >= 1e-36, dmag / torch.sqrt(torch.clamp_min(sq, 1e-36)),
                     torch.zeros_like(sq))
    rr = re + 1e-7
    den = rr * rr + im * im
    dspec = torch.cat([gm * re - dphs * im / den, gm * im + dphs * rr / den], dim=-1)
    ulp = torch.exp2(torch.floor(torch.log2(dspec.abs().clamp_min(1e-300))) - 7)
    moved = torch.cat([moved, moved], dim=-1)
    var = moved * torch.maximum(moved, ulp)
    dxp = framing.overlap_add((torch.matmul(var, (w * w).t()) * 0.25).transpose(0, 1), hop)
    dxp = F.pad(dxp, (0, xp.shape[1] - dxp.shape[1]))
    dw = torch.matmul((frames * frames).reshape(-1, ft).t(), var.reshape(-1, 2 * half))
    return k * torch.sqrt(dxp), k * torch.sqrt(dw)


# ------------------------------------------------------------ plain versions
# In bfloat16 each rounds, with round_operand, exactly the operands that the
# JAX kernel casts, and multiplies in its input's own dtype (float32: with
# TF32 off on the card, as the callers that compare set it).

def fused_analysis_reference(xp: torch.Tensor, w: torch.Tensor, ft: int, hop: int,
                             compute_dtype: torch.dtype = torch.float32):
    """Plain version of kernel A: framing, one GEMM, magnitude and phase."""
    _counters(ANALYSIS, ANALYSIS_BF16, compute_dtype).plain_calls += 1
    half = w.shape[1] // 2
    frames = framing.frame_signal(xp, ft, hop, pad=0) * 0.5  # (B, T, ft)
    frames, w = round_operand(frames, compute_dtype), round_operand(w, compute_dtype)
    spec = torch.matmul(frames.transpose(0, 1), w)  # (T, B, 2*half)
    return mag_phs(spec[..., :half], spec[..., half:])


def fused_synthesis_reference(mag: torch.Tensor, phs: torch.Tensor, w: torch.Tensor,
                              ft: int, hop: int,
                              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of kernel B: trig, one GEMM, overlap-add, trim."""
    _counters(SYNTHESIS, SYNTHESIS_BF16, compute_dtype).plain_calls += 1
    spec = torch.cat([mag * torch.cos(phs), mag * torch.sin(phs)], dim=-1)
    spec, w = round_operand(spec, compute_dtype), round_operand(w, compute_dtype)
    frames = torch.matmul(spec, w).transpose(0, 1)  # (B, OT, ft)
    wave = framing.overlap_add(frames, hop)
    return wave[:, ft : wave.shape[1] - ft]


def fused_analysis_bwd_reference(xp: torch.Tensor, w: torch.Tensor, dmag: torch.Tensor,
                                 dphs: torch.Tensor, ft: int, hop: int,
                                 compute_dtype: torch.dtype = torch.float32):
    """Plain version of kernel D, written out: (dxp, dw) from the saved
    (xp, w) and the cotangents of (mag, phs).

    The spectrum is computed again; the magnitude term is zero under the
    1e-36 floor (the gradient of clamp_min passes where sq >= 1e-36); the
    phase term is the adjoint of atan2(im, re + 1e-7) with plain division;
    dframe = 0.5 * dspec @ w.T is overlap-added at t*hop; dw = frame.T @ dspec
    over all (t, b) rows. In bfloat16 the halved frame, w and dspec are
    rounded."""
    _counters(ANALYSIS_BWD, ANALYSIS_BWD_BF16, compute_dtype).plain_calls += 1
    half = w.shape[1] // 2
    frames, w, dspec = analysis_bwd_dspec_reference(xp, w, dmag, dphs, ft, hop, compute_dtype)
    dframes = torch.matmul(dspec, w.t()) * 0.5  # (T, B, ft)
    dxp = framing.overlap_add(dframes.transpose(0, 1), hop)
    dxp = F.pad(dxp, (0, xp.shape[1] - dxp.shape[1]))  # samples past the last frame
    dw = torch.matmul(frames.reshape(-1, ft).t(), dspec.reshape(-1, 2 * half))
    return dxp, dw


def analysis_bwd_dspec_reference(xp: torch.Tensor, w: torch.Tensor, dmag: torch.Tensor,
                                 dphs: torch.Tensor, ft: int, hop: int,
                                 compute_dtype: torch.dtype = torch.float32):
    """The first half of kernel D's plain version: the two operands of its
    products and dspec, each rounded as the compute dtype rounds it: (halved
    frames (T, B, ft), w, dspec (T, B, 2*half), re then im)."""
    half = w.shape[1] // 2
    frames = framing.frame_signal(xp, ft, hop, pad=0).transpose(0, 1) * 0.5  # (T, B, ft)
    frames, w = round_operand(frames, compute_dtype), round_operand(w, compute_dtype)
    spec = torch.matmul(frames, w)
    re, im = spec[..., :half], spec[..., half:]
    sq = re * re + im * im
    gm = torch.where(sq >= 1e-36, dmag / torch.sqrt(torch.clamp_min(sq, 1e-36)),
                     torch.zeros_like(sq))
    rr = re + 1e-7
    den = rr * rr + im * im
    dspec = torch.cat([gm * re - dphs * im / den, gm * im + dphs * rr / den], dim=-1)
    return frames, w, round_operand(dspec, compute_dtype)


def fused_synthesis_bwd_reference(mag: torch.Tensor, phs: torch.Tensor, w: torch.Tensor,
                                  dout: torch.Tensor, ft: int, hop: int,
                                  compute_dtype: torch.dtype = torch.float32):
    """Plain version of kernel E, written out: (dmag, dphs, dw) from the saved
    (mag, phs, w) and the cotangent of the trimmed waveform.

    dout is padded by ft zeros on both sides (the adjoint of the trim) and
    framed (the adjoint of the overlap-add); dspec = dframe @ w.T;
    dw = spec.T @ dframe with spec = (mag*cos, mag*sin) computed again;
    dmag = d_re*cos + d_im*sin, dphs = mag*(d_im*cos - d_re*sin). The first
    and last frame lie wholly in the trimmed margin: exact zeros. In bfloat16
    dframe, w and spec are rounded."""
    _counters(SYNTHESIS_BWD, SYNTHESIS_BWD_BF16, compute_dtype).plain_calls += 1
    half = mag.shape[-1]
    dframes = framing.frame_signal(dout, ft, hop, pad=ft).transpose(0, 1)  # (OT, B, ft)
    dframes, w = round_operand(dframes, compute_dtype), round_operand(w, compute_dtype)
    dspec = torch.matmul(dframes, w.t())
    c, s = torch.cos(phs), torch.sin(phs)
    spec = round_operand(torch.cat([mag * c, mag * s], dim=-1), compute_dtype)
    dw = torch.matmul(spec.reshape(-1, 2 * half).t(), dframes.reshape(-1, ft))
    d_re, d_im = dspec[..., :half], dspec[..., half:]
    return d_re * c + d_im * s, mag * (d_im * c - d_re * s), dw


# ------------------------------------------------------------------ wrappers

def _is_cpu(t: torch.Tensor) -> bool:
    """The dispatch rule: True for a CPU tensor (plain version), False for a
    CUDA tensor (kernel); anything else is refused."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got one on {t.device}")
    return False


def _analysis_dims(xp: torch.Tensor, w: torch.Tensor, ft: int, hop: int):
    if xp.dim() != 2 or w.dim() != 2:
        raise ValueError("fused_analysis: xp must be (B, Lp) and w (ft, 2*half)")
    b, lp = xp.shape
    half = w.shape[1] // 2
    t = (lp - ft) // hop + 1
    if b < 1 or t < 1 or lp < ft:
        raise ValueError(f"fused_analysis: no frame fits (B={b}, Lp={lp}, ft={ft})")
    if max(b * lp, t * pad_rows(b) * packed_width(half, torch.bfloat16)) >= 2 ** 31:
        raise ValueError(f"fused_analysis: too large for 32-bit offsets (B={b}, Lp={lp}, T={t})")
    return b, lp, half, t


def _synthesis_dims(mag: torch.Tensor, ft: int, hop: int):
    if mag.dim() != 3:
        raise ValueError("fused_synthesis: mag and phs must be (OT, B, half)")
    ot, b, half = mag.shape
    out_len = (ot - 1) * hop - ft
    if b < 1 or out_len < 1:
        raise ValueError(f"fused_synthesis: empty output (OT={ot}, B={b}, ft={ft}, hop={hop})")
    rows = max(0, ot - 2) * pad_rows(b)
    if max(b * (out_len + 2 * ft), rows * max(ft, packed_width(half, torch.bfloat16))) >= 2 ** 31:
        raise ValueError(f"fused_synthesis: too large for 32-bit offsets (OT={ot}, B={b}, ft={ft})")
    return ot, b, half, out_len


def _empty(dev: torch.device, dtype: torch.dtype):
    """torch.empty on dev in dtype, of the shape given as arguments."""
    return lambda *shape: torch.empty(shape, device=dev, dtype=dtype)


def _analysis_fwd(xp: torch.Tensor, w: torch.Tensor, ft: int, hop: int,
                  compute_dtype: torch.dtype, schedule: str | None = None):
    count = _counters(ANALYSIS, ANALYSIS_BF16, compute_dtype)
    lp = xp.shape[1] if xp.dim() == 2 else 0
    sched = schedule_for(schedule, compute_dtype, ft, hop, lp, "A", aligned_16(xp))
    if _is_cpu(xp):
        return fused_analysis_reference(xp, w, ft, hop, compute_dtype)
    dev = xp.device
    b, lp, half, t = _analysis_dims(xp, w, ft, hop)
    _cuda.require(xp, "xp", (b, lp), dev)
    _cuda.require(w, "w", (ft, 2 * half), dev)
    f32 = _empty(dev, torch.float32)
    bf16 = compute_dtype == torch.bfloat16
    mag, phs = f32(t, b, half), f32(t, b, half)
    sc = _scratch(analysis_fwd_scratch(compute_dtype, b, lp, ft, half, sched), dev)
    ptrs = [_cuda.ptr(v) for v in (xp, w, *sc.values(), mag, phs)]
    with torch.cuda.device(dev):
        if sched == "wgmma":
            name, args = (("st_analysis_fwd_wgmma", _ANALYSIS_WGMMA_ARGS) if bf16
                          else ("st_analysis_fwd_wgmma_f32", _ANALYSIS_WGMMA_F32_ARGS))
            f = _cuda.function("frontend", name, args)
            status = f(*ptrs, b, lp, ft, hop, half, t, _cuda.stream(dev))
        else:
            count = ANALYSIS_BF16_MMA if bf16 else ANALYSIS_MMA
            vec = copy_width(ft, hop, lp, xp if sc["xq"] is None else sc["xq"], sc["wp"],
                             dtype=compute_dtype)
            f = _cuda.function("frontend", "st_analysis_fwd", _ANALYSIS_ARGS)
            status = f(*ptrs, b, lp, ft, hop, half, t, vec, int(bf16), _cuda.stream(dev))
    _cuda.check(f, status)
    count.launches += 1
    return mag, phs


def _synthesis_fwd(mag: torch.Tensor, phs: torch.Tensor, w: torch.Tensor, ft: int, hop: int,
                   compute_dtype: torch.dtype, schedule: str | None = None) -> torch.Tensor:
    count = _counters(SYNTHESIS, SYNTHESIS_BF16, compute_dtype)
    sched = schedule_for(schedule, compute_dtype, ft, hop, None, "B")
    if _is_cpu(mag):
        return fused_synthesis_reference(mag, phs, w, ft, hop, compute_dtype)
    dev = mag.device
    ot, b, half, out_len = _synthesis_dims(mag, ft, hop)
    _cuda.require(mag, "mag", (ot, b, half), dev)
    _cuda.require(phs, "phs", (ot, b, half), dev)
    _cuda.require(w, "w", (2 * half, ft), dev)
    sc = _scratch(synthesis_fwd_scratch(sched, compute_dtype, b, ot, ft, half), dev)
    out = torch.empty((b, out_len), device=dev, dtype=torch.float32)
    ptrs = [_cuda.ptr(v) for v in (mag, phs, w, *sc.values(), out)]
    bf16 = compute_dtype == torch.bfloat16
    with torch.cuda.device(dev):
        if sched == "wgmma":
            name, args = (("st_synthesis_fwd_wgmma", _SYNTHESIS_WGMMA_ARGS) if bf16
                          else ("st_synthesis_fwd_wgmma_f32", _SYNTHESIS_WGMMA_F32_ARGS))
            f = _cuda.function("frontend", name, args)
            status = f(*ptrs, b, ot, ft, hop, half, out_len, _cuda.stream(dev))
        else:
            count = SYNTHESIS_BF16_MMA if bf16 else SYNTHESIS_MMA
            nsplit = sc["frames"].shape[0]
            f = _cuda.function("frontend", "st_synthesis_fwd", _SYNTHESIS_ARGS)
            status = f(*ptrs, b, ot, ft, hop, half, out_len, nsplit,
                       copy_width(0, 0, 0, sc["wp"], sc["spec"], dtype=compute_dtype),
                       int(bf16), _cuda.stream(dev))
    _cuda.check(f, status)
    count.launches += 1
    return out


def fused_analysis_bwd(xp: torch.Tensor, w: torch.Tensor, dmag: torch.Tensor,
                       dphs: torch.Tensor, ft: int, hop: int,
                       need_dxp: bool = True, need_dw: bool = True,
                       compute_dtype: torch.dtype = torch.float32, schedule: str | None = None):
    """Kernel D on CUDA tensors, its plain version on CPU tensors:
    (dxp (B, Lp), dw (ft, 2*half)); a gradient that is not needed is None.
    ``schedule``: None (the rule, ``schedule_for``), "wgmma" or "mma"."""
    return _analysis_bwd(xp, w, dmag, dphs, ft, hop, need_dxp, need_dw, compute_dtype,
                         schedule)[:2]


def analysis_bwd_dspec(xp: torch.Tensor, w: torch.Tensor, dmag: torch.Tensor,
                       dphs: torch.Tensor, ft: int, hop: int, schedule: str | None = None):
    """Kernel D in bf16 on CUDA tensors, as ``fused_analysis_bwd`` without
    dxp, and the bf16 dspec that its dW product multiplied, read back from the
    launch's scratch: (dw, dspec (T, B, 2*half) in float32, re then im as the
    plain version lays it out). ``cli/time_frontend.py`` splits D's error
    against float64 by it."""
    if _is_cpu(xp):
        raise ValueError("analysis_bwd_dspec reads a kernel's scratch: it takes CUDA tensors")
    _, dw, sc = _analysis_bwd(xp, w, dmag, dphs, ft, hop, False, True, torch.bfloat16, schedule)
    t, b, half = dmag.shape
    ldc = sc["dspec"].shape[1]
    d = sc["dspec"].view(t, -1, ldc)[:, :b, :2 * half].float().reshape(t, b, half, 2)
    return dw, torch.cat([d[..., 0], d[..., 1]], dim=-1)


def _analysis_bwd(xp, w, dmag, dphs, ft, hop, need_dxp, need_dw, compute_dtype, schedule):
    """fused_analysis_bwd, and the scratch of its launch (None on the CPU)."""
    count = _counters(ANALYSIS_BWD, ANALYSIS_BWD_BF16, compute_dtype)
    b, lp = xp.shape if xp.dim() == 2 else (0, 0)
    sched = schedule_for(schedule, compute_dtype, ft, hop, lp, "D", aligned_16(xp))
    if _is_cpu(xp):
        dxp, dw = fused_analysis_bwd_reference(xp, w, dmag, dphs, ft, hop, compute_dtype)
        return (dxp if need_dxp else None), (dw if need_dw else None), None
    dev = xp.device
    b, lp, half, t = _analysis_dims(xp, w, ft, hop)
    _cuda.require(xp, "xp", (b, lp), dev)
    _cuda.require(w, "w", (ft, 2 * half), dev)
    _cuda.require(dmag, "dmag", (t, b, half), dev)
    _cuda.require(dphs, "dphs", (t, b, half), dev)
    f32 = _empty(dev, torch.float32)
    bf16 = compute_dtype == torch.bfloat16
    dxp = f32(b, lp) if need_dxp else None
    dw = f32(ft, 2 * half) if need_dw else None
    sc = _scratch(analysis_bwd_scratch(sched, compute_dtype, b, lp, ft, half, t, need_dxp,
                                       need_dw), dev)
    ins = [_cuda.ptr(xp), _cuda.ptr(w), _cuda.ptr(dmag), _cuda.ptr(dphs)]
    with torch.cuda.device(dev):
        if sched == "wgmma":
            name, args = (("st_analysis_bwd_wgmma", _ANALYSIS_BWD_WGMMA_ARGS) if bf16
                          else ("st_analysis_bwd_wgmma_f32", _ANALYSIS_BWD_WGMMA_F32_ARGS))
            f = _cuda.function("frontend_bwd", name, args)
            status = f(*ins, *(_cuda.ptr(v) for v in sc.values()), _cuda.ptr(dxp), _cuda.ptr(dw),
                       b, lp, ft, hop, half, t, int(need_dxp), int(need_dw), _cuda.stream(dev))
        else:
            count = ANALYSIS_BWD_BF16_MMA if bf16 else ANALYSIS_BWD_MMA
            nsplit = k_slices(ft, sc["wp"].shape[1], t * b)
            vec = copy_width(ft, hop, lp, xp if sc["xq"] is None else sc["xq"], sc["wp"],
                             sc["dspec"], dtype=compute_dtype)
            f = _cuda.function("frontend_bwd", "st_analysis_bwd", _ANALYSIS_BWD_ARGS)
            status = f(*ins, *(_cuda.ptr(v) for v in sc.values()), _cuda.ptr(dxp), _cuda.ptr(dw),
                       b, lp, ft, hop, half, t, nsplit, int(need_dxp), int(need_dw), vec,
                       int(bf16), _cuda.stream(dev))
    _cuda.check(f, status)
    count.launches += 1
    return dxp, dw, sc


def fused_synthesis_bwd(mag: torch.Tensor, phs: torch.Tensor, w: torch.Tensor,
                        dout: torch.Tensor, ft: int, hop: int, need_dw: bool = True,
                        compute_dtype: torch.dtype = torch.float32, schedule: str | None = None):
    """Kernel E on CUDA tensors, its plain version on CPU tensors:
    (dmag, dphs (OT, B, half), dw (2*half, ft) or None). ``schedule``: None
    (the rule, ``schedule_for``), "wgmma" or "mma"."""
    count = _counters(SYNTHESIS_BWD, SYNTHESIS_BWD_BF16, compute_dtype)
    out_len = dout.shape[-1]
    sched = schedule_for(schedule, compute_dtype, ft, hop, out_len + 2 * ft, "E")
    if _is_cpu(mag):
        dmag, dphs, dw = fused_synthesis_bwd_reference(mag, phs, w, dout, ft, hop, compute_dtype)
        return dmag, dphs, (dw if need_dw else None)
    dev = mag.device
    ot, b, half, out_len = _synthesis_dims(mag, ft, hop)
    _cuda.require(mag, "mag", (ot, b, half), dev)
    _cuda.require(phs, "phs", (ot, b, half), dev)
    _cuda.require(w, "w", (2 * half, ft), dev)
    _cuda.require(dout, "dout", (b, out_len), dev)
    lp = out_len + 2 * ft
    f32 = _empty(dev, torch.float32)
    dmag, dphs = f32(ot, b, half), f32(ot, b, half)
    dw = f32(2 * half, ft) if need_dw else None
    sc = _scratch(synthesis_bwd_scratch(sched, compute_dtype, b, ot, ft, half, out_len, need_dw),
                  dev)
    ins = [_cuda.ptr(mag), _cuda.ptr(phs), _cuda.ptr(w), _cuda.ptr(dout)]
    outs = [_cuda.ptr(dmag), _cuda.ptr(dphs), _cuda.ptr(dw)]
    bf16 = compute_dtype == torch.bfloat16
    with torch.cuda.device(dev):
        if sched == "wgmma":
            name, args = (("st_synthesis_bwd_wgmma", _SYNTHESIS_BWD_WGMMA_ARGS) if bf16
                          else ("st_synthesis_bwd_wgmma_f32", _SYNTHESIS_BWD_WGMMA_F32_ARGS))
            f = _cuda.function("frontend_bwd", name, args)
            status = f(*ins, *(_cuda.ptr(v) for v in sc.values()), *outs, b, ot, ft, hop, half,
                       out_len, int(need_dw), _cuda.stream(dev))
        else:
            count = SYNTHESIS_BWD_BF16_MMA if bf16 else SYNTHESIS_BWD_MMA
            ldc, rows = packed_width(half, compute_dtype), max(0, ot - 2) * b
            n_dspec, n_dw = k_slices(rows, ldc, ft), k_slices(ft, ldc, rows)
            f = _cuda.function("frontend_bwd", "st_synthesis_bwd", _SYNTHESIS_BWD_ARGS)
            status = f(*ins, *(_cuda.ptr(v) for v in sc.values()), *outs, b, ot, ft, hop, half,
                       out_len, n_dspec, n_dw, int(need_dw),
                       copy_width(ft, hop, lp, sc["doutp"], sc["wp"], sc["dspec"],
                                  dtype=compute_dtype),
                       int(bf16), _cuda.stream(dev))
    _cuda.check(f, status)
    count.launches += 1
    return dmag, dphs, dw


# ------------------------------------------------------- autograd Functions

class FusedAnalysis(torch.autograd.Function):
    """(xp, w) -> (mag, phs): kernel A forward, kernel D backward (their plain
    versions on CPU tensors), in one compute dtype. Saves (xp, w) only; D
    computes the spectrum again. ``schedule`` is A's; D takes its rule's."""

    @staticmethod
    def forward(ctx, xp, w, ft, hop, compute_dtype, schedule=None):
        ctx.save_for_backward(xp, w)
        ctx.geometry = (ft, hop, compute_dtype)
        return _analysis_fwd(xp, w, ft, hop, compute_dtype, schedule)

    @staticmethod
    def backward(ctx, dmag, dphs):
        xp, w = ctx.saved_tensors
        ft, hop, compute_dtype = ctx.geometry
        # the cotangents may be expanded or strided views; the kernels take
        # raw pointers
        dxp, dw = fused_analysis_bwd(xp, w, dmag.contiguous(), dphs.contiguous(), ft, hop,
                                     need_dxp=ctx.needs_input_grad[0],
                                     need_dw=ctx.needs_input_grad[1],
                                     compute_dtype=compute_dtype)
        return dxp, dw, None, None, None, None


class FusedSynthesis(torch.autograd.Function):
    """(mag, phs, w) -> waveform: kernel B forward, kernel E backward (their
    plain versions on CPU tensors), in one compute dtype. Saves (mag, phs,
    w); E computes the spectrum again. ``schedule`` is B's; E takes its
    rule's."""

    @staticmethod
    def forward(ctx, mag, phs, w, ft, hop, compute_dtype, schedule=None):
        ctx.save_for_backward(mag, phs, w)
        ctx.geometry = (ft, hop, compute_dtype)
        return _synthesis_fwd(mag, phs, w, ft, hop, compute_dtype, schedule)

    @staticmethod
    def backward(ctx, dout):
        mag, phs, w = ctx.saved_tensors
        ft, hop, compute_dtype = ctx.geometry
        dmag, dphs, dw = fused_synthesis_bwd(mag, phs, w, dout.contiguous(), ft, hop,
                                             need_dw=ctx.needs_input_grad[2],
                                             compute_dtype=compute_dtype)
        return (dmag if ctx.needs_input_grad[0] else None,
                dphs if ctx.needs_input_grad[1] else None, dw, None, None, None, None)


def fused_analysis(xp: torch.Tensor, w: torch.Tensor, ft: int, hop: int,
                   compute_dtype: torch.dtype = torch.float32, schedule: str | None = None):
    """Kernel A (backward: kernel D) on CUDA tensors, the plain versions on
    CPU tensors. ``schedule``: A's, None (the rule, ``schedule_for``),
    "wgmma" or "mma"."""
    return FusedAnalysis.apply(xp, w, ft, hop, compute_dtype, schedule)


def fused_synthesis(mag: torch.Tensor, phs: torch.Tensor, w: torch.Tensor,
                    ft: int, hop: int, compute_dtype: torch.dtype = torch.float32,
                    schedule: str | None = None) -> torch.Tensor:
    """Kernel B (backward: kernel E) on CUDA tensors, the plain versions on
    CPU tensors. ``schedule``: B's, None (the rule, ``schedule_for`` with
    ``lp=None``), "wgmma" or "mma"."""
    return FusedSynthesis.apply(mag, phs, w, ft, hop, compute_dtype, schedule)
