"""Unit CTR-GC on the card: the wrappers of the CUDA kernels.

  K1 `unit_ctr_gc_fwd`       csrc/unit_ctr_gc_fwd.cu        forward
  K2 `unit_ctr_gc_bwd_dx3`   csrc/unit_ctr_gc_bwd_dx3.cu    x3 gradient
  K3 `unit_ctr_gc_bwd_param` csrc/unit_ctr_gc_bwd_param.cu  parameter gradients
                             csrc/unit_ctr_gc_bwd_param_bf16.cu  (its bf16 form)
  K6 `unit_ctr_gc_bwd_conv3` csrc/unit_ctr_gc_bwd_conv3.cu  x3 gradient through
                                                            conv3's VJP
  K4 bf16 `ctr_gc_fused_bf16`, `ctr_gc_fused_t_bf16`
                             csrc/ctr_gc_fused.cu           the standalone
                                        CTR-GC op's bf16 forward and transpose

Counterparts of tamgcn_tpu/ops/pallas/ctr_gc.py:unit_ctr_gc_fwd_pallas,
unit_ctr_gc_bwd_pallas, unit_ctr_gc_bwd_conv3_pallas and, in bf16,
_fused_pallas_call (forward and transpose_m). The kernels' plain versions
are ops/aggregation.py:unit_ctr_gc_plain, unit_ctr_gc_dx3_plain,
unit_ctr_gc_param_grads_plain, unit_ctr_gc_bwd_conv3_plain and
ctr_gc_fused_plain (with ctr_gc_fused_dx3_plain). Each wrapper checks its
inputs, allocates the outputs (and scratch) and launches its kernel on the
current stream; it never falls back to the plain version.

K1 and K2 each have two designs in their source: the whole-V kernel
(csrc/unit_ctr_gc_whole.cuh, V <= 24), which keeps M of one subset and 16
channels for all V x V joint pairs in shared memory, and the joint-tiled
kernel (csrc/unit_ctr_gc_tiled.cuh) past it (V = 256). The launcher picks
one from the shape; `fwd_variant` and `dx3_variant` ask it which and
`fwd_blocks` and `dx3_blocks` how many blocks it launches. The C launchers
count the launches of each design where they launch the kernel
(`fwd_launched`, `dx3_launched`, `fused_launched`), and each wrapper counts
a launch on the counter of the design whose C count its call moved, never
on the query's word.

K1, K2 and K3 take their activations (x1s, x2s, x3s, g and the outputs of
those shapes) in float32 or in bfloat16, the JAX package's bf16 mixed
precision, and their parameters (w4s, b4s, alpha, As) in float32 in both
forms; the wrappers dispatch on the activations' dtype, and each form
counts its launches on its own counter (the bf16 ones end in `_bf16`).
K3's bf16 form is a design of its own in its own source (its products on
the tensor cores), whose C launcher counts its launches
(`param_bf16_launched`). K6 takes the same two forms: bf16 activations
(x1s, x2s, g, x and w3), the JAX kernel's bf16 body. K4's bf16 form
takes bf16 x1, x2 and x3 (forward) or an f32 g (transpose) with f32
parameters and returns f32; its f32 op runs K1 and K2 at S = 1.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

FWD_SOURCE = "unit_ctr_gc_fwd.cu"
DX3_SOURCE = "unit_ctr_gc_bwd_dx3.cu"
PARAM_SOURCE = "unit_ctr_gc_bwd_param.cu"
PARAM_BF16_SOURCE = "unit_ctr_gc_bwd_param_bf16.cu"
CONV3_SOURCE = "unit_ctr_gc_bwd_conv3.cu"
FUSED_SOURCE = "ctr_gc_fused.cu"
# what the launchers return for a shape they do not take
_CUDA_ERROR_INVALID_VALUE = 1
# kernel launches so far, one count per kernel; a run sets them to 0 and reads
# them to show that a path went through the kernels
launches = 0  # K1, whole-V design
launches_tiled = 0  # K1, joint-tiled design
bwd_dx3_launches = 0  # K2, whole-V design
bwd_dx3_tiled_launches = 0  # K2, joint-tiled design
bwd_param_launches = 0  # K3
bwd_conv3_launches = 0  # K6
# the bf16 forms
launches_bf16 = 0  # K1, whole-V design
launches_tiled_bf16 = 0  # K1, joint-tiled design
bwd_dx3_launches_bf16 = 0  # K2, whole-V design
bwd_dx3_tiled_launches_bf16 = 0  # K2, joint-tiled design
bwd_param_launches_bf16 = 0  # K3
bwd_conv3_launches_bf16 = 0  # K6
k4_launches_bf16 = 0  # K4 forward, whole-V design
k4_tiled_launches_bf16 = 0  # K4 forward, joint-tiled design
k4_t_launches_bf16 = 0  # K4 transpose (the x3 gradient), whole-V design
k4_t_tiled_launches_bf16 = 0  # K4 transpose, joint-tiled design

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "unit_ctr_gc_fwd_f32": (FWD_SOURCE, [_P] * 8 + [_I] * 6 + [_P], ctypes.c_int),
    "unit_ctr_gc_fwd_bf16": (FWD_SOURCE, [_P] * 8 + [_I] * 6 + [_P], ctypes.c_int),
    "unit_ctr_gc_fwd_variant": (FWD_SOURCE, [_I] * 3, ctypes.c_int),
    "unit_ctr_gc_fwd_blocks": (FWD_SOURCE, [_I] * 6, ctypes.c_longlong),
    "unit_ctr_gc_fwd_launched": (FWD_SOURCE, [_I], ctypes.c_longlong),
    "unit_ctr_gc_bwd_dx3_f32": (DX3_SOURCE, [_P] * 8 + [_I] * 6 + [_P], ctypes.c_int),
    "unit_ctr_gc_bwd_dx3_bf16": (DX3_SOURCE, [_P] * 8 + [_I] * 6 + [_P], ctypes.c_int),
    "unit_ctr_gc_bwd_dx3_variant": (DX3_SOURCE, [_I] * 3, ctypes.c_int),
    "unit_ctr_gc_bwd_dx3_blocks": (DX3_SOURCE, [_I] * 6, ctypes.c_longlong),
    "unit_ctr_gc_bwd_dx3_launched": (DX3_SOURCE, [_I], ctypes.c_longlong),
    "unit_ctr_gc_bwd_param_f32": (
        PARAM_SOURCE, [_P] * 14 + [_I] * 6 + [_P], ctypes.c_int),
    "unit_ctr_gc_bwd_param_bf16": (
        PARAM_BF16_SOURCE, [_P] * 14 + [_I] * 6 + [_P], ctypes.c_int),
    "unit_ctr_gc_bwd_param_scratch_floats": (
        PARAM_SOURCE, [_I] * 5, ctypes.c_longlong),
    "unit_ctr_gc_bwd_param_bf16_scratch_floats": (
        PARAM_BF16_SOURCE, [_I] * 5, ctypes.c_longlong),
    "unit_ctr_gc_bwd_param_bf16_launched": (PARAM_BF16_SOURCE, [], ctypes.c_longlong),
    "unit_ctr_gc_bwd_param_blocks": (PARAM_SOURCE, [_I] * 4, ctypes.c_longlong),
    "unit_ctr_gc_bwd_conv3_f32": (
        CONV3_SOURCE, [_P] * 13 + [_I] * 7 + [_P], ctypes.c_int),
    "unit_ctr_gc_bwd_conv3_bf16": (
        CONV3_SOURCE, [_P] * 13 + [_I] * 7 + [_P], ctypes.c_int),
    "unit_ctr_gc_bwd_conv3_scratch_floats": (
        CONV3_SOURCE, [_I] * 7, ctypes.c_longlong),
    "ctr_gc_fused_bf16": (FUSED_SOURCE, [_P] * 8 + [_I] * 5 + [_P], ctypes.c_int),
    "ctr_gc_fused_t_bf16": (FUSED_SOURCE, [_P] * 8 + [_I] * 5 + [_P], ctypes.c_int),
    "ctr_gc_fused_launched": (FUSED_SOURCE, [_I] * 2, ctypes.c_longlong),
}


def _kernel(name: str):
    """The C entry point `name`, its library built and loaded at first use."""
    source, argtypes, restype = _SIGNATURES[name]
    return build.entry(source, name, argtypes, restype)


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _activation_dtype(fn_name, named, activations):
    """The one dtype, float32 or bfloat16, of the tensors named in
    `activations` (float32 where there are none); raises on any other dtype
    and on a mix."""
    acts = [(name, t) for name, t, _ in named if name in activations]
    if not acts:
        return torch.float32
    first, dtype = acts[0][0], acts[0][1].dtype
    listed = ", ".join(name for name, _ in acts)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{first} is {dtype}; {fn_name} takes its activations "
                        f"({listed}) in float32 or bfloat16")
    for name, t in acts[1:]:
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype} but {first} is {dtype}: the "
                            f"activations of {fn_name} ({listed}) take one dtype")
    return dtype


def _check_unit(fn_name, device, named, R, C, aligned=(), activations=()):
    """Device, dtype, shape and contiguity of every (name, tensor, shape);
    R <= 32; C % 4 == 0 and the alignment of 4 values (16 bytes in float32,
    8 in bfloat16) of the tensors named in `aligned` (read 4 channels at a
    time), where there are any. The tensors named in `activations` are all
    float32 or all bfloat16, every other tensor float32; returns the
    activations' dtype."""
    if device.type != "cuda":
        raise ValueError(f"{fn_name} takes CUDA tensors, got {device}")
    act = _activation_dtype(fn_name, named, activations)
    for name, t, shape in named:
        if name not in activations and t.dtype != torch.float32:
            raise TypeError(
                f"{name} is {t.dtype}; {fn_name} takes it in float32"
                + (" with float32 and with bfloat16 activations" if activations else ""))
        _check(name, t, shape, device, act if name in activations else torch.float32)
    if R > 32:
        raise ValueError(f"R={R}: the kernel takes R <= 32")
    if aligned and C % 4:
        raise ValueError(f"C={C}: the kernel reads channels in fours and "
                         "takes C % 4 == 0")
    for name, t, _ in named:
        align = 4 * t.element_size()
        if name in aligned and t.data_ptr() % align:
            raise ValueError(f"{name} is not {align}-byte aligned")
    return act


# what the unit op's launchers (K1-K3) refuse once the checks of
# _check_unit pass: every V fits one of their designs
_UNIT_REFUSED = "its grid takes N <= 65535 and S * ceil(V / 16) <= 65535"


def _launch(fn, device, dims, *args,
            refused="what a block keeps of the refined adjacency must fit in "
                    "its shared memory (V = 20 and V = 25 fit at every R <= 32)"):
    """Launch the C entry point `fn` (a launcher of csrc/) on the current
    stream of `device`; raise on a non-zero return, with `refused` saying
    what the launcher does not take where it returns cudaErrorInvalidValue."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    name = fn.__name__
    shape = " ".join(f"{k}={v}" for k, v in dims.items())
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{name} does not take {shape}: {refused}")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({shape})")


def _launch_counted(launched, fn, device, dims, *args, **kwargs) -> str:
    """_launch(fn, device, dims, *args, **kwargs), then the design ("whole"
    or "tiled") whose count launched(design), kept by the C launcher where it
    launches the kernel, the call moved."""
    before = [launched(d) for d in _DESIGNS]
    _launch(fn, device, dims, *args, **kwargs)
    moved = [d for d, n in zip(_DESIGNS, before) if launched(d) != n]
    if len(moved) != 1:
        raise RuntimeError(f"{fn.__name__} counted launches of {moved or 'no design'}")
    return moved[0]


def _unit_dims(x1s, x3s_or_g, w4s):
    N, S, V, R = x1s.shape
    return N, S, x3s_or_g.shape[1], V, R, w4s.shape[-1]


def fwd_variant(S: int, V: int, R: int) -> str:
    """The design K1's launcher takes at (S, V, R <= 32): "whole" (M of a
    channel tile for all V x V pairs in shared memory) or "tiled"."""
    return _DESIGNS[_kernel("unit_ctr_gc_fwd_variant")(S, V, R)]


def dx3_variant(S: int, V: int, R: int) -> str:
    """The design K2's launcher takes at (S, V, R <= 32), as fwd_variant."""
    return _DESIGNS[_kernel("unit_ctr_gc_bwd_dx3_variant")(S, V, R)]


_DESIGNS = ("whole", "tiled")


def fwd_launched(design: str) -> int:
    """Launches of K1's `design` ("whole" or "tiled"), f32 and bf16, that
    its C launcher counted where it launched the kernel."""
    return _kernel("unit_ctr_gc_fwd_launched")(_DESIGNS.index(design))


def dx3_launched(design: str) -> int:
    """Launches of K2's `design`, as fwd_launched."""
    return _kernel("unit_ctr_gc_bwd_dx3_launched")(_DESIGNS.index(design))


def fused_launched(design: str, transpose: bool = False) -> int:
    """Launches of K4-bf16's forward (or, with `transpose`, its transposed
    call) in `design`, as fwd_launched."""
    return _kernel("ctr_gc_fused_launched")(int(transpose), _DESIGNS.index(design))


def param_bf16_launched() -> int:
    """Launches of K3's bf16 form that its C launcher counted where it
    launched the kernel."""
    return _kernel("unit_ctr_gc_bwd_param_bf16_launched")()


def fwd_blocks(N: int, S: int, T: int, V: int, R: int, C: int) -> int:
    """Blocks of K1's launch at the shape, in the design fwd_variant names
    (f32; -1 where the launcher does not take the shape)."""
    return _kernel("unit_ctr_gc_fwd_blocks")(N, S, T, V, R, C)


def dx3_blocks(N: int, S: int, T: int, V: int, R: int, C: int) -> int:
    """Blocks of K2's launch at the shape, as fwd_blocks."""
    return _kernel("unit_ctr_gc_bwd_dx3_blocks")(N, S, T, V, R, C)


# the whole-V design's block (csrc/unit_ctr_gc_whole.cuh, V <= 24): 16
# channels of one sample and, for K1, a tile of at most 16 frames (the
# frames split into ceil(T / 16) balanced tiles), for K2 one subset (all
# frames)
WHOLE_CHANNELS = 16
WHOLE_FRAMES = 16


def whole_v_blocks(N: int, S: int, T: int, C: int, fwd: bool = True) -> int:
    """Blocks of the whole-V K1 (fwd) or K2 launch at (N, S, T, C): a copy
    of csrc/unit_ctr_gc_whole.cuh:grid that needs no build, held to
    fwd_blocks and dx3_blocks by tests/test_torch_cuda.py."""
    channel_tiles = -(-C // WHOLE_CHANNELS)
    return channel_tiles * (-(-T // WHOLE_FRAMES) if fwd else S) * N


def bwd_param_blocks(N: int, S: int, V: int, C: int) -> int:
    """Blocks of K3's main kernel at (N, S, V, C)."""
    return _kernel("unit_ctr_gc_bwd_param_blocks")(N, S, V, C)


def unit_ctr_gc_fwd(x1s, x2s, x3s, w4s, b4s, alpha, As):
    """K1. x1s/x2s (N,S,V,R); x3s (N,T,V,S*C); w4s (S,R,C); b4s (S,C);
    alpha (1,); As (S,V,V), all contiguous on one CUDA device, the
    activations x1s, x2s, x3s float32 or bfloat16 and the rest float32, with
    R <= 32 and C % 4 == 0, any V (the whole-V or the joint-tiled design, as
    fwd_variant says) -> out (N,T,V,C) in the activations' dtype. Its
    gradient is K2 and K3, through ops/aggregation.py:UnitCtrGc."""
    global launches, launches_tiled, launches_bf16, launches_tiled_bf16
    N, S, T, V, R, C = _unit_dims(x1s, x3s, w4s)
    device = x3s.device
    act = _check_unit("unit_ctr_gc_fwd", device, (
        ("x1s", x1s, (N, S, V, R)),
        ("x2s", x2s, (N, S, V, R)),
        ("x3s", x3s, (N, T, V, S * C)),
        ("w4s", w4s, (S, R, C)),
        ("b4s", b4s, (S, C)),
        ("alpha", alpha, (1,)),
        ("As", As, (S, V, V)),
    ), R, C, aligned=("x3s", "w4s", "b4s"), activations=("x1s", "x2s", "x3s"))
    bf16 = act == torch.bfloat16
    out = torch.empty((N, T, V, C), device=device, dtype=act)
    tiled = _launch_counted(
        fwd_launched,
        _kernel("unit_ctr_gc_fwd_bf16" if bf16 else "unit_ctr_gc_fwd_f32"), device,
        dict(N=N, S=S, T=T, V=V, R=R, C=C),
        x1s.data_ptr(), x2s.data_ptr(), x3s.data_ptr(), w4s.data_ptr(),
        b4s.data_ptr(), alpha.data_ptr(), As.data_ptr(), out.data_ptr(),
        N, S, T, V, R, C, refused=_UNIT_REFUSED,
    ) == "tiled"
    if bf16 and tiled:
        launches_tiled_bf16 += 1
    elif bf16:
        launches_bf16 += 1
    elif tiled:
        launches_tiled += 1
    else:
        launches += 1
    return out


def unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As):
    """K2. The unit op's x3 gradient: x1s/x2s (N,S,V,R); g (N,T,V,C), the
    gradient of the output; w4s (S,R,C); b4s (S,C); alpha (1,); As (S,V,V),
    all contiguous on one CUDA device, x1s, x2s, g float32 or bfloat16 and the
    rest float32, with R <= 32 and C % 4 == 0, any V (as dx3_variant says)
    -> dx3s (N,T,V,S*C) in the dtype of g."""
    global bwd_dx3_launches, bwd_dx3_tiled_launches
    global bwd_dx3_launches_bf16, bwd_dx3_tiled_launches_bf16
    N, S, T, V, R, C = _unit_dims(x1s, g, w4s)
    device = g.device
    act = _check_unit("unit_ctr_gc_bwd_dx3", device, (
        ("x1s", x1s, (N, S, V, R)),
        ("x2s", x2s, (N, S, V, R)),
        ("g", g, (N, T, V, C)),
        ("w4s", w4s, (S, R, C)),
        ("b4s", b4s, (S, C)),
        ("alpha", alpha, (1,)),
        ("As", As, (S, V, V)),
    ), R, C, aligned=("g", "w4s", "b4s"), activations=("x1s", "x2s", "g"))
    bf16 = act == torch.bfloat16
    dx3s = torch.empty((N, T, V, S * C), device=device, dtype=act)
    tiled = _launch_counted(
        dx3_launched,
        _kernel("unit_ctr_gc_bwd_dx3_bf16" if bf16 else "unit_ctr_gc_bwd_dx3_f32"),
        device, dict(N=N, S=S, T=T, V=V, R=R, C=C),
        x1s.data_ptr(), x2s.data_ptr(), g.data_ptr(), w4s.data_ptr(),
        b4s.data_ptr(), alpha.data_ptr(), As.data_ptr(), dx3s.data_ptr(),
        N, S, T, V, R, C, refused=_UNIT_REFUSED,
    ) == "tiled"
    if bf16 and tiled:
        bwd_dx3_tiled_launches_bf16 += 1
    elif bf16:
        bwd_dx3_launches_bf16 += 1
    elif tiled:
        bwd_dx3_tiled_launches += 1
    else:
        bwd_dx3_launches += 1
    return dx3s


def unit_ctr_gc_bwd_param(x1s, x2s, g, x3s, w4s, b4s, alpha):
    """K3. The unit op's other gradients: x1s/x2s (N,S,V,R); g (N,T,V,C), the
    gradient of the output; x3s (N,T,V,S*C); w4s (S,R,C); b4s (S,C); alpha
    (1,), all contiguous on one CUDA device, x1s, x2s, g, x3s float32 or
    bfloat16 and the rest float32, with R <= 32 (any C and V)
    -> (dx1s, dx2s, dw4s, db4s, dalpha, dAs) shaped as x1s, x2s,
    w4s, b4s, alpha and (S,V,V), dx1s and dx2s in the activations' dtype and
    the rest float32. The sums over samples run in a fixed order: two calls
    on the same inputs give bitwise equal results. bfloat16 activations take
    the bf16 design (csrc/unit_ctr_gc_bwd_param_bf16.cu), counted where its
    C launcher moved its count."""
    global bwd_param_launches, bwd_param_launches_bf16
    N, S, T, V, R, C = _unit_dims(x1s, g, w4s)
    device = g.device
    act = _check_unit("unit_ctr_gc_bwd_param", device, (
        ("x1s", x1s, (N, S, V, R)),
        ("x2s", x2s, (N, S, V, R)),
        ("g", g, (N, T, V, C)),
        ("x3s", x3s, (N, T, V, S * C)),
        ("w4s", w4s, (S, R, C)),
        ("b4s", b4s, (S, C)),
        ("alpha", alpha, (1,)),
    ), R, C, activations=("x1s", "x2s", "g", "x3s"))
    bf16 = act == torch.bfloat16

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, device=device, dtype=dtype)

    dx1s, dx2s = empty(N, S, V, R, dtype=act), empty(N, S, V, R, dtype=act)
    dw4s, db4s, dalpha, dAs = empty(S, R, C), empty(S, C), empty(1), empty(S, V, V)
    form = "bf16" if bf16 else "f32"
    scratch_floats = "unit_ctr_gc_bwd_param_" + ("bf16_" if bf16 else "") + "scratch_floats"
    scratch = empty(_kernel(scratch_floats)(N, S, V, R, C))
    before = param_bf16_launched() if bf16 else 0
    _launch(
        _kernel("unit_ctr_gc_bwd_param_" + form), device, dict(N=N, S=S, T=T, V=V, R=R, C=C),
        x1s.data_ptr(), x2s.data_ptr(), g.data_ptr(), x3s.data_ptr(),
        w4s.data_ptr(), b4s.data_ptr(), alpha.data_ptr(), dx1s.data_ptr(),
        dx2s.data_ptr(), dw4s.data_ptr(), db4s.data_ptr(), dalpha.data_ptr(),
        dAs.data_ptr(), scratch.data_ptr(), N, S, T, V, R, C, refused=_UNIT_REFUSED,
    )
    if bf16:
        if param_bf16_launched() != before + 1:
            raise RuntimeError("unit_ctr_gc_bwd_param_bf16 did not count one launch")
        bwd_param_launches_bf16 += 1
    else:
        bwd_param_launches += 1
    return dx1s, dx2s, dw4s, db4s, dalpha, dAs


def unit_ctr_gc_bwd_conv3(x1s, x2s, g, x, w3, w4s, b4s, alpha, As):
    """K6. The unit op's x3 gradient carried through the packed conv3 that
    made x3s = x @ w3 + b3 (the x3 gradient passes between the kernel's two
    phases through scratch that the wrapper allocates): x1s/x2s
    (N,S,V,R); g (N,T,V,C), the gradient of the output; x (N,T,V,Cin),
    conv3's input; w3 (Cin,S*C), conv3's weight transposed (a transposed
    view of the contiguous (S*C,Cin) weight, as `conv3.weight.t()`, is taken
    as it is; any other w3 is copied into that layout); w4s (S,R,C); b4s
    (S,C); alpha (1,); As (S,V,V); on one CUDA device, contiguous, the
    activations x1s, x2s, g, x and w3 float32 or bfloat16 and the rest
    float32, with R <= 32 and C % 4 == 0 -> (dx, dw3, db3) shaped as x, w3
    and (S*C,) in the activations' dtype. dw3 is a transposed view of a
    contiguous (S*C,Cin) tensor. In bfloat16 the kernel follows the JAX
    kernel's bf16 body: its x3 gradient is f32, enters both products rounded
    to bf16 (the scratch holds it so) and db3 unrounded. Its sums over rows
    run in a fixed order: two calls on the same inputs give bitwise equal
    results."""
    global bwd_conv3_launches, bwd_conv3_launches_bf16
    N, S, T, V, R, C = _unit_dims(x1s, g, w4s)
    Cin = x.shape[-1]
    device = g.device
    if tuple(w3.shape) != (Cin, S * C):
        raise ValueError(f"w3 has shape {tuple(w3.shape)}, expected {(Cin, S * C)}")
    w3t = w3.t().contiguous()
    act = _check_unit("unit_ctr_gc_bwd_conv3", device, (
        ("x1s", x1s, (N, S, V, R)),
        ("x2s", x2s, (N, S, V, R)),
        ("g", g, (N, T, V, C)),
        ("x", x, (N, T, V, Cin)),
        ("w3", w3t, (S * C, Cin)),
        ("w4s", w4s, (S, R, C)),
        ("b4s", b4s, (S, C)),
        ("alpha", alpha, (1,)),
        ("As", As, (S, V, V)),
    ), R, C, aligned=("g", "w4s", "b4s"), activations=("x1s", "x2s", "g", "x", "w3"))
    bf16 = act == torch.bfloat16
    dims = dict(N=N, S=S, T=T, V=V, R=R, C=C, Cin=Cin)
    floats = _kernel("unit_ctr_gc_bwd_conv3_scratch_floats")(N, S, T, V, R, C, Cin)
    if floats < 0:
        raise ValueError(
            "unit_ctr_gc_bwd_conv3 does not take "
            + " ".join(f"{k}={v}" for k, v in dims.items())
            + ": its x3 gradient scratch (N*T*V*S*C floats) must hold fewer "
            "than 2**31 values")

    def empty(*shape, dtype=act):
        return torch.empty(shape, device=device, dtype=dtype)

    dx, dw3t, db3 = empty(N, T, V, Cin), empty(S * C, Cin), empty(S * C)
    # the x3 gradient (N,T,V,S*C), which passes between the kernel's two
    # phases (f32, or bf16 in the bf16 form), and the partial sums of dw3
    # and db3, in one f32 tensor
    scratch = empty(floats, dtype=torch.float32)
    _launch(
        _kernel("unit_ctr_gc_bwd_conv3_bf16" if bf16 else "unit_ctr_gc_bwd_conv3_f32"),
        device, dims,
        x1s.data_ptr(), x2s.data_ptr(), g.data_ptr(), w4s.data_ptr(),
        b4s.data_ptr(), alpha.data_ptr(), As.data_ptr(), x.data_ptr(),
        w3t.data_ptr(), dx.data_ptr(), dw3t.data_ptr(), db3.data_ptr(),
        scratch.data_ptr(), N, S, T, V, R, C, Cin, refused=_UNIT_REFUSED,
    )
    if bf16:
        bwd_conv3_launches_bf16 += 1
    else:
        bwd_conv3_launches += 1
    return dx, dw3t.t(), db3


def _check_fused_bf16(fn_name, x1, x2, src, src_name, w4, b4, alpha, A):
    """K4's bf16 operands through _check_unit: x1, x2 (N,V,R) bfloat16, src
    (N,T,V,C) bfloat16 as an activation (x3) or float32 (g); w4 (R,C), b4
    (C,), alpha (1,), A (V,V) float32. Returns (N, T, V, R, C)."""
    N, V, R = x1.shape
    T, C = src.shape[1], src.shape[-1]
    activations = ("x1", "x2", "x3") if src_name == "x3" else ("x1", "x2")
    act = _check_unit(fn_name, src.device, (
        ("x1", x1, (N, V, R)),
        ("x2", x2, (N, V, R)),
        (src_name, src, (N, T, V, C)),
        ("w4", w4, (R, C)),
        ("b4", b4, (C,)),
        ("alpha", alpha, (1,)),
        ("A", A, (V, V)),
    ), R, C, aligned=(src_name, "w4", "b4"), activations=activations)
    if act != torch.bfloat16:
        raise TypeError(f"x1 is {act}; {fn_name} takes bfloat16 x1 and x2 (its f32 "
                        "op runs K1 and K2 at S = 1)")
    return N, T, V, R, C


def ctr_gc_fused_bf16(x1, x2, x3, w4, b4, alpha, A):
    """K4's bf16 form, the forward: x1/x2 (N,V,R) and x3 (N,T,V,C) bfloat16;
    w4 (R,C), b4 (C,), alpha (1,), A (V,V) float32; contiguous on one CUDA
    device, R <= 32, C % 4 == 0, any V (the whole-V or the joint-tiled
    design, as fwd_variant(1, V, R) names) -> out (N,T,V,C) float32, with D
    = bf16(tanh(bf16(x1 - x2))) and an f32 w4, as the JAX kernel computes on
    bf16 operands."""
    global k4_launches_bf16, k4_tiled_launches_bf16
    N, T, V, R, C = _check_fused_bf16("ctr_gc_fused_bf16", x1, x2, x3, "x3", w4, b4, alpha, A)
    out = torch.empty((N, T, V, C), device=x3.device, dtype=torch.float32)
    if _launch_counted(fused_launched, _kernel("ctr_gc_fused_bf16"), x3.device,
                       dict(N=N, T=T, V=V, R=R, C=C),
                       x1.data_ptr(), x2.data_ptr(), x3.data_ptr(), w4.data_ptr(),
                       b4.data_ptr(), alpha.data_ptr(), A.data_ptr(), out.data_ptr(),
                       N, T, V, R, C, refused=_UNIT_REFUSED) == "tiled":
        k4_tiled_launches_bf16 += 1
    else:
        k4_launches_bf16 += 1
    return out


def ctr_gc_fused_t_bf16(x1, x2, g, w4, b4, alpha, A):
    """K4's bf16 form, the transpose (the x3 gradient,
    dx3[n,t,v,c] = sum_u M[n,u,v,c] g[n,t,u,c]): as ctr_gc_fused_bf16 with g
    (N,T,V,C) float32, the gradient of its f32 output, in x3's place ->
    dx3 (N,T,V,C) float32 (the design as dx3_variant(1, V, R) names)."""
    global k4_t_launches_bf16, k4_t_tiled_launches_bf16
    N, T, V, R, C = _check_fused_bf16("ctr_gc_fused_t_bf16", x1, x2, g, "g", w4, b4, alpha, A)
    dx3 = torch.empty((N, T, V, C), device=g.device, dtype=torch.float32)
    if _launch_counted(lambda d: fused_launched(d, transpose=True),
                       _kernel("ctr_gc_fused_t_bf16"), g.device,
                       dict(N=N, T=T, V=V, R=R, C=C),
                       x1.data_ptr(), x2.data_ptr(), g.data_ptr(), w4.data_ptr(),
                       b4.data_ptr(), alpha.data_ptr(), A.data_ptr(), dx3.data_ptr(),
                       N, T, V, R, C, refused=_UNIT_REFUSED) == "tiled":
        k4_t_tiled_launches_bf16 += 1
    else:
        k4_t_launches_bf16 += 1
    return dx3
