"""LayerNorm forward and backward on Hopper, with their plain PyTorch
versions.

Counterpart of ``elephas_tpu/ops/layer_norm.py`` with the same public
function, :func:`layer_norm`. A CUDA tensor goes through the hand-written
kernels in ``csrc/layer_norm.cu``: the forward (one pass over each row,
held in registers) and the backward, which is two launches (dx with
per-block dγ/dβ partial sums, then a reduction of the partials in a fixed
order). A CPU tensor goes through :func:`layer_norm_forward_reference` and
:func:`layer_norm_backward_reference`, the same formulas written out in
PyTorch. A tensor on any other device, or one the kernels do not take,
raises: there is no fallback to the plain version or to
``torch.nn.functional.layer_norm``.

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

# kernel launches since the last reset (chip_smoke.py reads them); the
# backward counts each of its two launches
fwd_launches = 0
bwd_launches = 0


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
    lib = _native.library("layer_norm")
    if lib.elephas_ln_fwd.argtypes is None:
        ptr, c_int = ctypes.c_void_p, ctypes.c_int
        lib.elephas_ln_fwd.argtypes = [ptr] * 6 + [c_int, c_int, c_int, ctypes.c_float, ptr]
        lib.elephas_ln_bwd_blocks.argtypes = [c_int, c_int, c_int, ctypes.POINTER(c_int)]
        lib.elephas_ln_bwd.argtypes = [ptr] * 8 + [c_int] * 4 + [ptr]
        lib.elephas_ln_bwd_reduce.argtypes = [ptr] * 4 + [c_int, c_int, ptr]
        for fn in (lib.elephas_ln_fwd, lib.elephas_ln_bwd_blocks, lib.elephas_ln_bwd,
                   lib.elephas_ln_bwd_reduce):
            fn.restype = c_int
        lib.elephas_cuda_error_string.argtypes = [c_int]
        lib.elephas_cuda_error_string.restype = ctypes.c_char_p
    return lib


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


def layer_norm_forward(x2, gamma, beta, eps: float):
    """``[N, d]`` rows → ``(y, mean [N], rstd [N])``. CPU tensors take the
    plain version; CUDA tensors launch the forward kernel."""
    global fwd_launches
    if _device_of(x2) == "cpu":
        return layer_norm_forward_reference(x2, gamma, beta, eps)
    _check_cuda_rows(x2)
    _check_vector("gamma", gamma, x2)
    _check_vector("beta", beta, x2)
    n, d = x2.shape
    y = torch.empty_like(x2)
    mean = torch.empty(n, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    if n == 0:
        return y, mean, rstd
    g32, b32 = gamma.float(), beta.float()
    lib = _kernel()
    with torch.cuda.device(x2.device):
        err = lib.elephas_ln_fwd(
            x2.data_ptr(), g32.data_ptr(), b32.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), _DTYPES[x2.dtype], n, d, float(eps),
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _raise_on(lib, err, "forward launch")
    fwd_launches += 1
    return y, mean, rstd


def layer_norm_backward(x2, gamma, dy, mean, rstd):
    """``(dx, dγ, dβ)`` for ``[N, d]`` rows. CPU tensors take the plain
    version; CUDA tensors launch the two backward kernels."""
    global bwd_launches
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
        err = lib.elephas_ln_bwd_reduce(
            parts[0].data_ptr(), parts[1].data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
            blocks.value, d, stream,
        )
        _raise_on(lib, err, "backward reduction launch")
        bwd_launches += 1
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


def layer_norm(x, gamma, beta, eps: float = 1e-6):
    """LayerNormalization over the last axis of ``x`` (any leading shape),
    Keras's math: f32 statistics, affine ``gamma``/``beta``, output in
    ``x``'s dtype. Differentiable through the backward kernels."""
    d = x.shape[-1]
    y = _LayerNorm.apply(x.reshape(-1, d), gamma, beta, float(eps))
    return y.reshape(x.shape)
