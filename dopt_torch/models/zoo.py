"""The reference CNNs and the dense models as worker-stacked PyTorch
modules.

Counterpart of dopt's Model1/Model3, MLP and LogisticRegression
(``dopt/models/zoo.py``) in the form its engines run them: the whole
fleet's forward as one program.  Every parameter carries a leading
worker axis ``[W, ...]``.  Each conv is ONE grouped
``F.conv2d(..., groups=W)`` over worker-major channels, so worker w's
channels meet only worker w's kernel (dopt's
``_make_stacked_cnn_apply``); each dense layer is a batched
``torch.baddbmm`` over the worker axis.

Parameters use PyTorch's own layouts (conv ``[W, Cout, Cin, kh, kw]``,
linear ``[W, out, in]``, the CNN's fc1 input in CHW flatten order);
``dopt_torch.convert`` maps them to and from dopt's flax trees.  The
public input stays dopt's NHWC ``[W, B, H, Wd, C]`` (``[W, B, D]`` for
tabular rows); the MLP and the logistic model flatten it in HWC order,
as flax's ``reshape`` does, so their first layer needs no reordering.

bf16 compute (``dtype=torch.bfloat16``) casts where dopt's forwards
cast: the input and every weight and bias go to bf16, the convs and
dense layers run in bf16, and a faithful head's softmax runs in f32
(``_head``).  The CNN's corrected head computes its logits layer in f32
on an f32 copy of the activation (zoo.py:136-145); the MLP and the
logistic model compute every layer, head included, in the compute
dtype.  Autograd through the casts hands f32 gradients to f32
parameters, as dopt's cast VJP does.  No ``torch.autocast``: its op
lists pick their own cast points.

Faithful quirks (``faithful=True``): no activation after the convs and
a softmax head, so the cross-entropy on top is the reference's double
softmax.  The 2×2 max pool routes tie gradients to the FIRST window
element in scan order — ``F.max_pool2d``'s backward already does, which
is what dopt's custom VJP reproduces (ties are common: zero-background
pixels under the no-ReLU conv give exact 4-way ties).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

_HIDDEN = {"model1": 512, "model3": 256}
MLP_HIDDEN = (200, 200)
# Each model's layers, in the order its parameters are registered.
LAYERS = {"model1": ("conv1", "conv2", "fc1", "fc2"),
          "model3": ("conv1", "conv2", "fc1", "fc2"),
          "mlp": ("fc1", "fc2", "head"), "logistic": ("linear",)}


def param_shapes(name: str, *, num_classes: int = 10,
                 input_shape: tuple[int, ...] = (28, 28, 1)
                 ) -> dict[str, tuple[int, ...]]:
    """Per-worker parameter shapes of a zoo model, in PyTorch layout."""
    if name not in LAYERS:
        raise ValueError(f"unknown model {name!r}; one of {sorted(LAYERS)}")
    if name == "mlp":
        a, b = MLP_HIDDEN
        return {"fc1.weight": (a, math.prod(input_shape)), "fc1.bias": (a,),
                "fc2.weight": (b, a), "fc2.bias": (b,),
                "head.weight": (num_classes, b), "head.bias": (num_classes,)}
    if name == "logistic":
        return {"linear.weight": (num_classes, math.prod(input_shape)),
                "linear.bias": (num_classes,)}
    h, w, c = input_shape
    hidden = _HIDDEN[name]
    flat = 64 * (h // 2 // 2) * (w // 2 // 2)
    return {
        "conv1.weight": (32, c, 5, 5), "conv1.bias": (32,),
        "conv2.weight": (64, 32, 5, 5), "conv2.bias": (64,),
        "fc1.weight": (hidden, flat), "fc1.bias": (hidden,),
        "fc2.weight": (num_classes, hidden), "fc2.bias": (num_classes,),
    }


def init_worker_params(name: str, *, num_classes: int = 10,
                       input_shape: tuple[int, ...] = (28, 28, 1),
                       generator: torch.Generator | None = None
                       ) -> dict[str, torch.Tensor]:
    """One worker's init of a zoo model with flax's defaults: LeCun-normal
    weights (normal truncated at ±2σ, σ = √(1/fan_in)/0.8796…) and zero
    biases.  Drawn on the CPU, so a seed gives the same init on every
    device."""
    out = {}
    for key, shape in param_shapes(name, num_classes=num_classes,
                                   input_shape=input_shape).items():
        t = torch.zeros(shape, dtype=torch.float32)
        if key.endswith("weight"):
            std = math.sqrt(1.0 / math.prod(shape[1:])) / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        out[key] = t
    return out


@contextlib.contextmanager
def full_f32(device: torch.device):
    """Run the f32 path in full f32 on ``device``, restoring the backend
    flags on exit.  CUDA: TF32 off for cuDNN convolutions and cuBLAS
    matmuls (cuDNN's TF32 default keeps about three digits), and bf16
    matmuls reduce in f32 as XLA's do (cuBLAS may otherwise reduce
    split-K partial sums in bf16).  CPU: oneDNN off, because its
    grouped-conv backward lost two digits against f64 on the faithful
    Model1 (3e-2 relative on conv2's weight gradient; 5e-7 with
    PyTorch's native kernels)."""
    if device.type == "cuda":
        m = torch.backends.cuda.matmul
        saved = (torch.backends.cudnn.allow_tf32, m.allow_tf32,
                 m.allow_bf16_reduced_precision_reduction)
        torch.backends.cudnn.allow_tf32 = False
        m.allow_tf32 = False
        m.allow_bf16_reduced_precision_reduction = False
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32, m.allow_tf32,
             m.allow_bf16_reduced_precision_reduction) = saved
    else:
        with torch.backends.mkldnn.flags(enabled=False):
            yield


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Run bit-reproducibly on ``device``, restoring every flag on exit:
    dopt's runs repeat bit for bit (XLA is deterministic), and its
    blocked ≡ per-round and resume contracts rest on that.  CUDA: cuDNN
    takes only deterministic algorithms and does not autotune, and
    ``torch.use_deterministic_algorithms`` makes every op on the path
    take its deterministic form (an op without one raises).  cuBLAS also
    needs ``CUBLAS_WORKSPACE_CONFIG`` before its first call, which
    ``dopt_torch/__init__.py`` sets.  The mode's NaN fill of every
    ``torch.empty`` is off: the port writes each tensor it allocates
    with ``empty`` in full before reading it (the step-metric buffers
    of ``engine.local.local_steps``, a block's metric buffer in
    ``engine.graphs``), and torch's own ops write theirs.  The CPU
    kernels the port runs are deterministic already; nothing changes
    there."""
    if device.type != "cuda":
        yield
        return
    import torch.utils.deterministic as det

    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             det.fill_uninitialized_memory)
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        (cudnn.deterministic, cudnn.benchmark, on, warn_only,
         det.fill_uninitialized_memory) = saved
        torch.use_deterministic_algorithms(on, warn_only=warn_only)


def _grouped_conv(z, weight, bias, groups, dtype):
    """'SAME' conv of worker-major channels with [W, Cout, Cin, k, k]
    kernels as one grouped conv, in ``dtype``."""
    k = weight.shape[-1]
    return F.conv2d(z, weight.reshape(-1, *weight.shape[2:]).to(dtype),
                    bias.reshape(-1).to(dtype), padding=k // 2,
                    groups=groups)


def _stacked_linear(zt, weight, bias, dtype):
    """Feature-major [W, in, B] → [W, out, B]: W @ zt + b, in ``dtype``.
    Kept feature-major so autograd hands back CONTIGUOUS [W, out, in]
    weight gradients (the fused update kernel takes contiguous
    tensors)."""
    return torch.baddbmm(bias.to(dtype).unsqueeze(2), weight.to(dtype), zt)


def stacked_cnn_forward(params: dict[str, torch.Tensor], x: torch.Tensor,
                        *, faithful: bool,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The fleet's forward: NHWC ``[W, B, H, Wd, C]`` inputs and
    ``[W, ...]`` params → f32 ``[W, B, num_classes]`` (probabilities
    when faithful, logits otherwise), computed in ``dtype``."""
    w, b, h, wd, c = x.shape
    z = x.to(dtype).permute(1, 0, 4, 2, 3).reshape(b, w * c, h, wd)
    z = _grouped_conv(z, params["conv1.weight"], params["conv1.bias"], w,
                      dtype)
    if not faithful:
        z = F.relu(z)
    z = F.max_pool2d(z, 2)
    z = _grouped_conv(z, params["conv2.weight"], params["conv2.bias"], w,
                      dtype)
    if not faithful:
        z = F.relu(z)
    z = F.max_pool2d(z, 2)
    # [B, W·C2, H', Wd'] → [W, C2·H'·Wd', B] (each worker's CHW flatten)
    z = z.reshape(b, w, -1).permute(1, 2, 0)
    z = F.relu(_stacked_linear(z, params["fc1.weight"], params["fc1.bias"],
                               dtype))
    # The corrected head's logits layer runs in f32 (dopt zoo.py:136-145).
    head = dtype if faithful else torch.float32
    z = _stacked_linear(z.to(head), params["fc2.weight"],
                        params["fc2.bias"], head)
    z = z.transpose(1, 2).float()             # [W, B, num_classes]
    return torch.softmax(z, dim=-1) if faithful else z


def stacked_dense_forward(params: dict[str, torch.Tensor], x: torch.Tensor,
                          *, layers: tuple[str, ...], faithful: bool,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The MLP's or the logistic model's fleet forward: ``[W, B, ...]``
    inputs, flattened per sample in HWC order, through ``layers`` (a
    ReLU after each but the last), every layer in ``dtype`` → f32
    ``[W, B, num_classes]`` (probabilities when faithful)."""
    w, b = x.shape[:2]
    z = x.to(dtype).reshape(w, b, -1).transpose(1, 2)    # [W, D, B]
    for i, layer in enumerate(layers):
        z = _stacked_linear(z, params[f"{layer}.weight"],
                            params[f"{layer}.bias"], dtype)
        if i < len(layers) - 1:
            z = F.relu(z)
    z = z.transpose(1, 2).float()             # [W, B, num_classes]
    return torch.softmax(z, dim=-1) if faithful else z


def stacked_forward(name: str, params: dict[str, torch.Tensor],
                    x: torch.Tensor, *, faithful: bool,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The fleet's forward of zoo model ``name`` (``LAYERS``' keys)."""
    if name not in LAYERS:
        raise ValueError(f"unknown model {name!r}; one of {sorted(LAYERS)}")
    if name in _HIDDEN:
        return stacked_cnn_forward(params, x, faithful=faithful, dtype=dtype)
    return stacked_dense_forward(params, x, layers=LAYERS[name],
                                 faithful=faithful, dtype=dtype)


class _Layer(nn.Module):
    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)


class StackedModel(nn.Module):
    """Zoo model ``name`` for a fleet of workers, built from a dict of
    ``[W, ...]`` tensors in ``param_shapes`` layout (stored in their own
    dtype) and computing in ``dtype``; its parameters are registered in
    ``LAYERS[name]`` order.  Model1 has 1,663,370 params a worker on
    28×28×1, Model3 1,105,098 on 32×32×3, the MLP 199,210 on 28×28×1 and
    the logistic model 248 on a9a's 123 features."""

    def __init__(self, name: str, params: dict[str, torch.Tensor], *,
                 faithful: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model_name = name
        self.faithful = faithful
        self.compute_dtype = dtype
        for layer in LAYERS[name]:
            setattr(self, layer, _Layer(params[f"{layer}.weight"],
                                        params[f"{layer}.bias"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stacked_forward(self.model_name, dict(self.named_parameters()),
                               x, faithful=self.faithful,
                               dtype=self.compute_dtype)


class StackedCNN(StackedModel):
    """Model1 or Model3 (they differ only in fc1's width, which the
    params carry)."""

    def __init__(self, params: dict[str, torch.Tensor], *, faithful: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__("model1", params, faithful=faithful, dtype=dtype)
