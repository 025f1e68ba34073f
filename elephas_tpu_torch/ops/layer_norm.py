"""LayerNorm forward and backward on Hopper, with their plain PyTorch
versions.

Counterpart of ``elephas_tpu/ops/layer_norm.py`` with the same public
function, :func:`layer_norm`. A CUDA tensor goes through the hand-written
kernels in ``csrc/layer_norm.cu``: the forward (one pass over each row,
held in registers; one warp a row up to d = 1024) and the backward, which
is two launches (dx with per-block dγ/dβ partial sums, then a reduction of
the partials in a fixed order). A CPU tensor goes through
:func:`layer_norm_forward_reference` and
:func:`layer_norm_backward_reference`, the same formulas written out in
PyTorch. A tensor on any other device, or one the kernels do not take,
raises: there is no fallback to the plain version or to
``torch.nn.functional.layer_norm``.

:func:`layer_norm` takes one of two routes (:func:`needs_grad`). When
autograd wants the call's gradient it goes through the autograd Function,
whose forward writes mean and rstd for the backward. Otherwise (under
``torch.inference_mode()`` or ``torch.no_grad()``, or when nothing
requires grad: the serving paths) :func:`layer_norm_inference` launches the
forward kernel directly and allocates and writes ``y`` only. Both routes
run the same kernel on the same rows, so ``y`` is the same bits.

Statistics are f32 and two-pass, as on the TPU: the mean first, then the
mean of ``(x - mean)²``. ``y`` and ``dx`` come back in ``x``'s dtype
(float32 or bfloat16), dγ and dβ in γ's.
"""

from __future__ import annotations

import ctypes

import torch

from elephas_tpu_torch.ops import _native

MAX_WIDTH = 8192
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32 = torch.float32

# kernel launches since the last reset (chip_smoke.py reads them), and
# those of them on the bf16 route; the backward counts each of its two
# launches
fwd_launches = 0
bwd_launches = 0
fwd_bf16_launches = 0
bwd_bf16_launches = 0

# the rows (one warp each) a forward block may take for d <= 1024
ROWS_PER_BLOCK = (1, 2, 4, 8)
_SMS: dict[int, int] = {}
_LIB = None  # the loaded library, its argument types set (_kernel)


def layer_norm_forward_reference(x2, gamma, beta, eps: float):
    """Plain version of the forward kernel: ``[N, d]`` rows →
    ``(y [N, d] in x's dtype, mean [N] f32, rstd [N] f32)``."""
    xf = x2.float()
    mean = xf.mean(dim=-1)
    xc = xf - mean[:, None]
    rstd = torch.rsqrt((xc * xc).mean(dim=-1) + eps)
    y = xc * rstd[:, None] * gamma.float() + beta.float()
    return y.to(x2.dtype), mean, rstd


def layer_norm_backward_reference(x2, gamma, dy, mean, rstd):
    """Plain version of the backward kernels: ``(dx [N, d] in x's dtype,
    dγ [d], dβ [d] in γ's dtype)``."""
    dyf = dy.float()
    xhat = (x2.float() - mean[:, None]) * rstd[:, None]
    wdy = dyf * gamma.float()
    c1 = wdy.mean(dim=-1, keepdim=True)
    c2 = (wdy * xhat).mean(dim=-1, keepdim=True)
    dx = (wdy - c1 - xhat * c2) * rstd[:, None]
    dgamma = (dyf * xhat).sum(dim=0)
    dbeta = dyf.sum(dim=0)
    return dx.to(x2.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


def _kernel():
    global _LIB
    lib = _native.library("layer_norm")
    if lib.elephas_ln_fwd.argtypes is None:
        ptr, c_int = ctypes.c_void_p, ctypes.c_int
        lib.elephas_ln_fwd.argtypes = [ptr] * 6 + [c_int, c_int, c_int, ctypes.c_float,
                                                   c_int, ptr]
        lib.elephas_ln_fwd_route.argtypes = [ptr] * 4 + [c_int, c_int]
        lib.elephas_ln_bwd_blocks.argtypes = [c_int, c_int, c_int, ctypes.POINTER(c_int)]
        lib.elephas_ln_bwd.argtypes = [ptr] * 8 + [c_int] * 4 + [ptr]
        lib.elephas_ln_bwd_reduce.argtypes = [ptr] * 4 + [c_int, c_int, ptr]
        for fn in (lib.elephas_ln_fwd, lib.elephas_ln_fwd_route, lib.elephas_ln_bwd_blocks,
                   lib.elephas_ln_bwd, lib.elephas_ln_bwd_reduce):
            fn.restype = c_int
        lib.elephas_cuda_error_string.argtypes = [c_int]
        lib.elephas_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def rows_per_block(n: int, sms: int) -> int:
    """Rows (one warp each) of a forward block for ``n`` rows of d <= 1024
    on a card of ``sms`` SMs: one while the rows are no more than the SMs,
    so each row has an SM to itself; two above that. The sweep over 1, 2,
    4 and 8 (chip_smoke.py, PERF.md §6) found 2 the best or within 1.5 %
    of it at 512 and 32,768 rows, 1 and 2 apart by no more than the
    sweep's noise at 16 rows, and 8 the slowest at 512 rows."""
    return 1 if n <= sms else 2


def _sm_count(index: int) -> int:
    sms = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def _current_raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as an integer handle
    (no Python ``Stream`` object)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch_fwd(index, x, g32, b32, y, mean, rstd, n: int, d: int, eps: float) -> None:
    """One forward launch on device ``index`` (x's) and its current
    stream; ``mean`` and ``rstd`` None write y only. Raises on a launch
    error."""
    lib = _LIB or _kernel()
    args = (x.data_ptr(), g32.data_ptr(), b32.data_ptr(), y.data_ptr(),
            None if mean is None else mean.data_ptr(),
            None if rstd is None else rstd.data_ptr(), _DTYPES[x.dtype], n, d, eps,
            rows_per_block(n, _SMS.get(index) or _sm_count(index)),
            _current_raw_stream(index))
    if index == torch._C._cuda_getDevice():
        err = lib.elephas_ln_fwd(*args)
    else:
        with torch.cuda.device(index):
            err = lib.elephas_ln_fwd(*args)
    if err:
        _raise_on(lib, err, "forward launch")


def forward_route(x2, gamma, beta) -> str:
    """The forward kernel's route for these CUDA operands and a fresh
    (16-byte aligned) y, as the kernel picks it: ``"vector"`` (one warp a
    row, 16-byte loads and stores), ``"scalar"`` (one warp a row, column
    by column) or ``"multi_warp"`` (d > 1024)."""
    y = torch.empty_like(x2)
    route = _kernel().elephas_ln_fwd_route(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), _DTYPES[x2.dtype],
        x2.shape[-1])
    if route < 0:
        raise ValueError(f"no forward route takes {tuple(x2.shape)} {x2.dtype}")
    return ("vector", "scalar", "multi_warp")[route]


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(
            f"layer-norm {what} failed: " + lib.elephas_cuda_error_string(err).decode()
        )


def _device_of(x2) -> str:
    if x2.device.type not in ("cuda", "cpu"):
        raise ValueError(f"layer_norm runs on cuda or cpu, not {x2.device}")
    return x2.device.type


def _check_rows(name, t, x2):
    if t.device != x2.device:
        raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
    if t.dtype != x2.dtype:
        raise ValueError(f"{name} is {t.dtype}, x is {x2.dtype}")
    if t.shape != x2.shape or not t.is_contiguous():
        raise ValueError(
            f"{name} must be contiguous [N, d] rows like x {tuple(x2.shape)}, "
            f"got shape {tuple(t.shape)} strides {tuple(t.stride())}"
        )


def _check_vector(name, t, x2):
    if t.device != x2.device:
        raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.shape != x2.shape[1:] or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous [{x2.shape[1]}] vector, got {tuple(t.shape)}"
        )


def _check_cuda_rows(x2):
    if x2.ndim != 2:
        raise ValueError(f"the layer-norm kernels take [N, d] rows, got {tuple(x2.shape)}")
    if x2.dtype not in _DTYPES:
        raise ValueError(f"the layer-norm kernels take float32 or bfloat16, got {x2.dtype}")
    if not x2.is_contiguous():
        raise ValueError(
            f"the layer-norm kernels take contiguous rows, got strides {tuple(x2.stride())}"
        )
    n, d = x2.shape
    if not 1 <= d <= MAX_WIDTH:
        raise ValueError(f"the layer-norm kernels take 1 <= d <= {MAX_WIDTH}, got d={d}")
    if n >= 2**31:
        raise ValueError(f"the layer-norm kernels take fewer than 2**31 rows, got {n}")


def layer_norm_forward(x2, gamma, beta, eps: float, stats: bool = True):
    """``[N, d]`` rows → ``(y, mean [N], rstd [N])``; with ``stats=False``
    ``(y, None, None)``, the kernel writing y only. CPU tensors take the
    plain version; CUDA tensors launch the forward kernel."""
    global fwd_launches, fwd_bf16_launches
    if _device_of(x2) == "cpu":
        y, mean, rstd = layer_norm_forward_reference(x2, gamma, beta, eps)
        return (y, mean, rstd) if stats else (y, None, None)
    _check_cuda_rows(x2)
    _check_vector("gamma", gamma, x2)
    _check_vector("beta", beta, x2)
    n, d = x2.shape
    y = torch.empty_like(x2)
    mean = rstd = None
    if stats:
        mean = torch.empty(n, dtype=torch.float32, device=x2.device)
        rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    if n == 0:
        return y, mean, rstd
    _launch_fwd(x2.get_device(), x2, gamma.float(), beta.float(), y, mean, rstd, n, d,
                float(eps))
    fwd_launches += 1
    fwd_bf16_launches += x2.dtype is torch.bfloat16
    return y, mean, rstd


def layer_norm_backward(x2, gamma, dy, mean, rstd):
    """``(dx, dγ, dβ)`` for ``[N, d]`` rows. CPU tensors take the plain
    version; CUDA tensors launch the two backward kernels."""
    global bwd_launches, bwd_bf16_launches
    if _device_of(x2) == "cpu":
        return layer_norm_backward_reference(x2, gamma, dy, mean, rstd)
    _check_cuda_rows(x2)
    _check_rows("dy", dy, x2)
    _check_vector("gamma", gamma, x2)
    n, d = x2.shape
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.device != x2.device or t.dtype != torch.float32 or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 [{n}] on {x2.device}")
    dx = torch.empty_like(x2)
    dgamma = torch.zeros(d, dtype=torch.float32, device=x2.device)
    dbeta = torch.zeros(d, dtype=torch.float32, device=x2.device)
    if n == 0:
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)
    g32 = gamma.float()
    lib = _kernel()
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        blocks = ctypes.c_int(0)
        _raise_on(lib, lib.elephas_ln_bwd_blocks(_DTYPES[x2.dtype], n, d, ctypes.byref(blocks)),
                  "backward grid query")
        parts = torch.empty(2, blocks.value, d, dtype=torch.float32, device=x2.device)
        err = lib.elephas_ln_bwd(
            x2.data_ptr(), g32.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), _DTYPES[x2.dtype],
            n, d, blocks.value, stream,
        )
        _raise_on(lib, err, "backward launch")
        bwd_launches += 1
        bwd_bf16_launches += x2.dtype is torch.bfloat16
        err = lib.elephas_ln_bwd_reduce(
            parts[0].data_ptr(), parts[1].data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
            blocks.value, d, stream,
        )
        _raise_on(lib, err, "backward reduction launch")
        bwd_launches += 1
        bwd_bf16_launches += x2.dtype is torch.bfloat16
    return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, gamma, beta, eps):
        y, mean, rstd = layer_norm_forward(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, mean, rstd = ctx.saved_tensors
        # autograd may hand over a broadcast gradient (a mean-pool's
        # backward): the kernel reads contiguous rows
        dx, dgamma, dbeta = layer_norm_backward(x2, gamma, dy.contiguous(), mean, rstd)
        return dx, dgamma, dbeta, None


def needs_grad(x, gamma, beta) -> bool:
    """Whether autograd wants the gradient of a LayerNorm of these
    operands: grad mode is on (not ``torch.no_grad()`` or
    ``torch.inference_mode()``) and one of them requires grad."""
    return torch.is_grad_enabled() and (
        x.requires_grad or gamma.requires_grad or beta.requires_grad)


def layer_norm_inference(x, gamma, beta, eps: float = 1e-6):
    """:func:`layer_norm`'s value without autograd or statistics: one
    forward launch that writes y only, on a CUDA tensor. The usual case
    (contiguous float32 or bfloat16 rows, float32 γ/β of width d on x's
    device) is decided by one predicate and launched at once; any other
    input takes the full checks, which raise what the kernel does not
    take. A CPU tensor takes the plain version."""
    global fwd_launches, fwd_bf16_launches
    d = x.shape[-1]
    index = x.get_device()
    if (x.is_cuda and x.dtype in _DTYPES and gamma.dtype is _F32
            and beta.dtype is _F32 and 0 < d <= MAX_WIDTH and x.is_contiguous()
            and gamma.is_contiguous() and beta.is_contiguous() and gamma.ndim == 1
            and gamma.shape[0] == d and beta.ndim == 1 and beta.shape[0] == d
            and gamma.get_device() == index and beta.get_device() == index
            and 0 < x.numel() < d * 2**31):
        y = torch.empty_like(x)
        _launch_fwd(index, x, gamma, beta, y, None, None, x.numel() // d, d, float(eps))
        fwd_launches += 1
        fwd_bf16_launches += x.dtype is torch.bfloat16
        return y
    return layer_norm_forward(x.reshape(-1, d), gamma, beta, eps, stats=False)[0].reshape(
        x.shape)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, gamma, beta, eps):
        y, mean, rstd = layer_norm_forward(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, mean, rstd = ctx.saved_tensors
        # autograd may hand over a broadcast gradient (a mean-pool's
        # backward): the kernel reads contiguous rows
        dx, dgamma, dbeta = layer_norm_backward(x2, gamma, dy.contiguous(), mean, rstd)
        return dx, dgamma, dbeta, None


def layer_norm(x, gamma, beta, eps: float = 1e-6):
    """LayerNormalization over the last axis of ``x`` (any leading shape),
    Keras's math: f32 statistics, affine ``gamma``/``beta``, output in
    ``x``'s dtype. Differentiable through the backward kernels when
    autograd wants the gradient (:func:`needs_grad`); otherwise
    :func:`layer_norm_inference`."""
    if needs_grad(x, gamma, beta):
        d = x.shape[-1]
        return _LayerNorm.apply(x.reshape(-1, d), gamma, beta, float(eps)).reshape(x.shape)
    return layer_norm_inference(x, gamma, beta, eps)
