"""The reference CNNs, the dense models and the GroupNorm ResNet-18 as
worker-stacked PyTorch modules, and dopt's sequence model.

Counterpart of dopt's Model1/Model3, MLP, LogisticRegression and
ResNet18 (``dopt/models/zoo.py``) in the form its engines run them: the
whole fleet's forward as one program.  Every parameter carries a leading
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
on an f32 copy of the activation (zoo.py:136-145); the MLP, the
logistic model and ResNet-18 compute every layer, head included, in the
compute dtype.  Autograd through the casts hands f32 gradients to f32
parameters, as dopt's cast VJP does.  No ``torch.autocast``: its op
lists pick their own cast points.

ResNet-18 (dopt's ``ResNet18``/``ResidualBlock``, run as its
``_make_stacked_resnet_apply``): 3×3 convs without bias, GroupNorm with
``min(32, C)`` groups a worker, a 1×1 projection shortcut wherever the
shape changes, a global mean pool and a ``head`` layer computed in the
compute dtype.  Its parameters keep dopt's nested names as dotted ones
(``ResidualBlock_0.Conv_0.weight``, ``GroupNorm_0.scale``), registered
in sorted order, which is dopt's flatten order.

Faithful quirks (``faithful=True``): no activation after the convs and
a softmax head, so the cross-entropy on top is the reference's double
softmax.  The 2×2 max pool routes tie gradients to the FIRST window
element in scan order — ``F.max_pool2d``'s backward already does, which
is what dopt's custom VJP reproduces (ties are common: zero-background
pixels under the no-ReLU conv give exact 4-way ties).

On CUDA a differentiated f32 conv of Model1 or Model3 is
``_RoundedConv``: its output and weight gradient are summed in f64 by
GEMMs and rounded once, so the card's step stays within 1e-6 of the
CPU's (the CPU, and the eval forward, keep the library's f32 conv); a
differentiated f32 hidden layer of the MLP is ``_RoundedLinear``, its
output summed in f64 and rounded once, so its ReLU routes as the exact
sum does.  ResNet-18's f32 training convs and GroupNorms are summed in
f64 and rounded once on the CPU and the card alike
(``_RoundedResNetConv``, ``_RoundedGroupNorm``), so both devices route
every ReLU the same (``ROUNDED_F64`` lists each model's rounded
layers).

``TransformerLM`` is dopt's decoder-only LM (zoo.py:249-308), the model
of ``SeqLMTrainer``: one model with no worker axis, fed one rank's slice
of the sequence, its attention injected (``dopt_torch.parallel.
sequence``).  ``count_params`` counts any of them.
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
RESNET_STAGES = (2, 2, 2, 2)   # ResNet18.stage_sizes' default
# The worker-stacked models the gossip and federated engines run.
STACKED = (*LAYERS, "resnet18")
# Every model of the zoo (dopt's ``_ZOO``): the stacked ones and the
# SeqLMTrainer's TransformerLM.
MODELS = (*STACKED, "transformer")


def _resnet_shapes(num_classes: int, channels: int, stage_sizes
                   ) -> dict[str, tuple[int, ...]]:
    """ResNet-18's shapes in sorted name order.  Stage s has 64·2^s
    channels and strides 2 in its first block when s > 0; a block has the
    projection shortcut (``Conv_2``) exactly when its channels change,
    which is exactly when it strides."""
    shapes = {"Conv_0.weight": (64, channels, 3, 3),
              "GroupNorm_0.scale": (64,), "GroupNorm_0.bias": (64,)}
    blocks = [64 * 2 ** stage for stage, n in enumerate(stage_sizes)
              for _ in range(n)]
    cout = 64
    for k, (cin, cout) in enumerate(zip([64, *blocks], blocks)):
        blk = f"ResidualBlock_{k}"
        convs = [(cout, cin, 3, 3), (cout, cout, 3, 3)]
        if cin != cout:
            convs.append((cout, cin, 1, 1))
        for i, shape in enumerate(convs):
            shapes[f"{blk}.Conv_{i}.weight"] = shape
            shapes[f"{blk}.GroupNorm_{i}.scale"] = (cout,)
            shapes[f"{blk}.GroupNorm_{i}.bias"] = (cout,)
    shapes["head.weight"] = (num_classes, cout)
    shapes["head.bias"] = (num_classes,)
    return {k: shapes[k] for k in sorted(shapes)}


def param_shapes(name: str, *, num_classes: int = 10,
                 input_shape: tuple[int, ...] = (28, 28, 1),
                 stage_sizes=None) -> dict[str, tuple[int, ...]]:
    """Per-worker parameter shapes of a zoo model, in PyTorch layout
    (ResNet-18's in sorted name order; ``stage_sizes`` is its block
    count a stage, None for the default (2, 2, 2, 2))."""
    if name not in STACKED:
        raise ValueError(f"unknown model {name!r}; one of {sorted(STACKED)}")
    if name == "resnet18":
        return _resnet_shapes(num_classes, input_shape[-1],
                              tuple(stage_sizes or RESNET_STAGES))
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
                       generator: torch.Generator | None = None,
                       stage_sizes=None) -> dict[str, torch.Tensor]:
    """One worker's init of a zoo model with flax's defaults: LeCun-normal
    weights (normal truncated at ±2σ, σ = √(1/fan_in)/0.8796…), zero
    biases and GroupNorm scales of one.  Drawn on the CPU, so a seed
    gives the same init on every device."""
    out = {}
    for key, shape in param_shapes(name, num_classes=num_classes,
                                   input_shape=input_shape,
                                   stage_sizes=stage_sizes).items():
        t = torch.zeros(shape, dtype=torch.float32)
        if key.endswith("scale"):
            t.fill_(1.0)
        elif key.endswith("weight"):
            _lecun_normal_(t, generator)
        out[key] = t
    return out


def _lecun_normal_(t: torch.Tensor, generator) -> None:
    """flax's LeCun-normal kernel init of a torch-layout ``[out, in, ...]``
    weight, in place."""
    std = math.sqrt(1.0 / math.prod(t.shape[1:])) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


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


def _patches(z: torch.Tensor, k: int, padding: int) -> torch.Tensor:
    """im2col of a stride-1 'SAME' conv as one strided copy:
    ``[B, C·k·k, H·W]``, rows in (c, kh, kw) order (``F.unfold``'s)."""
    b, c, h, w = z.shape
    zp = F.pad(z, (padding,) * 4)
    s = zp.stride()
    return zp.as_strided((b, c, k, k, h, w),
                         (s[0], s[1], s[2], s[3], s[2], s[3])).reshape(
        b, c * k * k, h * w)


class _RoundedConv:
    """The card's f32 'SAME' grouped conv, its output and weight gradient
    summed in f64 (GEMMs over one im2col copy, kept for the backward) and
    rounded once to f32; the input gradient is the library's (cuDNN's
    dgrad).

    The faithful Model1 max-pools its conv outputs with no ReLU between,
    and a pool routes its gradient to one element: where two elements of
    a window lie within the conv's rounding of each other, two devices
    that sum the conv in different orders route it differently.  At
    ``headline-dsgd-model1``'s full size (batch 128 a lane) the card's
    f32 conv2 was 1.05e-5 from f64 where the CPU's was 2.0e-6, one of
    2,408,448 windows routed apart, and the step's conv weight gradients
    landed 0.8-1.8e-4 relative L2 from the CPU's; with an f64 output the
    routing was the CPU's, and then cuDNN's Winograd weight gradient (its
    deterministic pick for conv2 at 6 lanes) was still 1.25e-3 off.  With
    both in f64 every tensor of the step is within 1e-6 of the CPU's
    (``chip_smoke.py`` phase 4c).

    ``apply(z, weight, bias, padding, groups)`` returns the output; the
    autograd function under it also returns the im2col copy (as an
    output, so ``torch.func`` can take it: ``setup_context`` saves it),
    and its ``vmap`` rule folds a vmapped worker axis into the conv's
    groups — the same grouped conv the stacked forward calls, so dopt's
    ``stacked_impl="vmap"`` takes the same arithmetic on the card."""

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(z, weight, bias, padding, groups):
            b, (h, w) = z.shape[0], z.shape[2:]
            cout = weight.shape[0] // groups
            cols = _patches(z.double(), weight.shape[-1], padding).view(
                b, groups, -1, h * w)                      # [B, G, CKK, L]
            out = torch.matmul(weight.double().view(1, groups, cout, -1),
                               cols)
            out = out + bias.double().view(1, groups, cout, 1)
            return out.view(b, groups * cout, h, w).float(), cols

        @staticmethod
        def setup_context(ctx, inputs, output):
            z, weight, _, padding, groups = inputs
            cols = output[1]
            ctx.mark_non_differentiable(cols)
            ctx.set_materialize_grads(False)
            ctx.save_for_backward(z, weight, cols)
            ctx.padding, ctx.groups = padding, groups

        @staticmethod
        def backward(ctx, grad, _cols_grad):
            z, weight, cols = ctx.saved_tensors
            b, groups = z.shape[0], ctx.groups
            gz = gw = gb = None
            if ctx.needs_input_grad[0]:
                gz = torch.nn.grad.conv2d_input(z.shape, weight, grad,
                                                padding=ctx.padding,
                                                groups=groups)
            if ctx.needs_input_grad[1]:
                # One GEMM a (sample, group) — its positions — then the
                # samples' partial sums.
                g = grad.double().reshape(b * groups,
                                          weight.shape[0] // groups, -1)
                part = torch.bmm(g, cols.view(b * groups, *cols.shape[2:])
                                 .transpose(1, 2))
                gw = part.view(b, *weight.shape).sum(0).float()
            if ctx.needs_input_grad[2]:
                gb = grad.sum((0, 2, 3))
            return gz, gw, gb, None, None

        @staticmethod
        def vmap(info, in_dims, z, weight, bias, padding, groups):
            """V vmapped workers' convs as one conv of V·groups groups:
            the workers' channels side by side, sample-major, as the
            stacked forward lays them out."""
            v = info.batch_size
            z, weight, bias = (
                t.movedim(d, 0) if d is not None else t.expand(v, *t.shape)
                for t, d in zip((z, weight, bias), in_dims[:3]))
            b = z.shape[1]
            out, cols = _RoundedConv.Fn.apply(
                z.transpose(0, 1).reshape(b, -1, *z.shape[3:]),
                weight.reshape(-1, *weight.shape[2:]), bias.reshape(-1),
                padding, v * groups)
            return ((out.view(b, v, -1, *out.shape[2:]),
                     cols.view(cols.shape[0], v, groups, *cols.shape[2:])),
                    (1, 1))

    @staticmethod
    def apply(z, weight, bias, padding, groups) -> torch.Tensor:
        return _RoundedConv.Fn.apply(z, weight, bias, padding, groups)[0]


def _grouped_conv(z, weight, bias, groups, dtype):
    """'SAME' conv of worker-major channels with [W, Cout, Cin, k, k]
    kernels as one grouped conv, in ``dtype``: a differentiated f32 conv
    on CUDA through ``_RoundedConv``.  The CPU's own f32 conv sums within
    2e-6 of f64, and it is the one held against dopt; an eval forward
    routes no gradient, and its f64 patches would hold 2-5 GB at the
    headlines' eval batches."""
    k = weight.shape[-1]
    w = weight.reshape(-1, *weight.shape[2:]).to(dtype)
    b = bias.reshape(-1).to(dtype)
    if dtype == torch.float32 and z.is_cuda and torch.is_grad_enabled():
        return _RoundedConv.apply(z, w, b, k // 2, groups)
    return F.conv2d(z, w, b, padding=k // 2, groups=groups)


class _RoundedLinear(torch.autograd.Function):
    """The card's f32 hidden layer of the MLP in training:
    ``_RoundedLinear.apply(bias, weight, zt)`` on ``[W, out]``, ``[W,
    out, in]`` and ``[W, in, B]`` gives W·z + b summed in f64 and
    rounded once to f32 (the input and weight gradients are the
    library's f32 GEMMs, the bias gradient a sum over the batch).

    A ReLU after a dense layer routes each sample's gradient by the sign
    of its pre-activation, and where that lies within the sum's rounding
    of zero two devices that sum in different orders route it apart.  At
    ``baseline1``'s full size (the MLP, 4 lanes, batch 64, 470 steps a
    round) the card's batched f32 GEMM put one of the first step's
    51,200 fc2 pre-activations at −1.2e-9 where f64 gives +5.8e-7 and the
    CPU's f32 +3.4e-7; that one sample moved its lane's fc2 gradient by
    1.1e-2 (max-relative), and after the round the card's params were
    9.3e-3 from the CPU's, the reference oracle's on either device
    within 3.8e-5 (``chip_smoke.py`` phase 21a).  Rounded once from f64,
    the card routes by the sign the exact sum has.  The CNNs' fc1 keeps
    the library's f32 GEMM: a model rounds one kind of layer
    (``ROUNDED_F64``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(bias, weight, zt):
        return torch.baddbmm(bias.double().unsqueeze(2), weight.double(),
                             zt.double()).float()

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, weight, zt = inputs
        ctx.save_for_backward(weight, zt)

    @staticmethod
    def backward(ctx, grad):
        weight, zt = ctx.saved_tensors
        gb = grad.sum(2) if ctx.needs_input_grad[0] else None
        gw = (torch.bmm(grad, zt.transpose(1, 2))
              if ctx.needs_input_grad[1] else None)
        gz = (torch.bmm(weight.transpose(1, 2), grad)
              if ctx.needs_input_grad[2] else None)
        return gb, gw, gz


# The port's f64 tensor work: each model's layers that are summed in f64
# and rounded once in f32 training, and the device-time phase their f64
# kernels belong to.  A kernel's name cannot tell a conv's f64 GEMM from
# a dense layer's, so a model's rounded layers share one phase, and
# ``utils.profiling.device_stats_of(model=...)`` files the f64 kernels of
# a window by this table (tests/test_torch_profiling.py holds the
# package's f64 sites to its classes).  ResNet-18's GroupNorms, rounded
# with its convs, file their f64 kernels under conv too.
ROUNDED_F64 = {"model1": (("_RoundedConv",), "conv"),
               "model3": (("_RoundedConv",), "conv"),
               "mlp": (("_RoundedLinear",), "other"),
               "resnet18": (("_RoundedResNetConv", "_RoundedGroupNorm"),
                            "conv")}


def _stacked_linear(zt, weight, bias, dtype):
    """Feature-major [W, in, B] → [W, out, B]: W @ zt + b, in ``dtype``.
    Kept feature-major so autograd hands back CONTIGUOUS [W, out, in]
    weight gradients (the fused update kernel takes contiguous
    tensors)."""
    return torch.baddbmm(bias.to(dtype).unsqueeze(2), weight.to(dtype), zt)


def _mlp_hidden(zt, weight, bias, dtype):
    """A hidden layer of the MLP and its ReLU: a differentiated f32
    layer on CUDA sums through ``_RoundedLinear``, as ``_grouped_conv``
    takes ``_RoundedConv``."""
    if dtype == torch.float32 and zt.is_cuda and torch.is_grad_enabled():
        return F.relu(_RoundedLinear.apply(bias.to(dtype), weight.to(dtype),
                                           zt))
    return F.relu(_stacked_linear(zt, weight, bias, dtype))


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
        dense = _mlp_hidden if i < len(layers) - 1 else _stacked_linear
        z = dense(z, params[f"{layer}.weight"], params[f"{layer}.bias"],
                  dtype)
    z = z.transpose(1, 2).float()             # [W, B, num_classes]
    return torch.softmax(z, dim=-1) if faithful else z


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's 'SAME' padding of one spatial axis: the total split with
    the odd element after, so a stride-2 3×3 conv of an even axis pads
    (0, 1), where ``F.conv2d(padding=1)`` would pad (1, 1)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _resnet_conv(z, weight, groups, dtype, stride=1):
    """'SAME' conv without bias of worker-major channels with
    [W, Cout, Cin, k, k] kernels, as one grouped conv in ``dtype``; an
    uneven 'SAME' padding is applied explicitly first.  A differentiated
    f32 conv, on either device, is ``_RoundedResNetConv``."""
    k = weight.shape[-1]
    (ht, hb), (wl, wr) = (_same_pad(n, k, stride) for n in z.shape[2:])
    if ht == hb and wl == wr:
        pad = (ht, wl)
    else:
        z, pad = F.pad(z, (wl, wr, ht, hb)), 0
    w = weight.reshape(-1, *weight.shape[2:]).to(dtype)
    if _rounds_resnet(dtype):
        return _RoundedResNetConv.apply(z, w, stride, pad, groups)
    return F.conv2d(z, w, stride=stride, padding=pad, groups=groups)


def _rounds_resnet(dtype) -> bool:
    """ResNet-18's f32 training forward sums its convs and GroupNorms in
    f64 and rounds each once (``_RoundedResNetConv``,
    ``_RoundedGroupNorm``), on the CPU and the card alike."""
    return dtype == torch.float32 and torch.is_grad_enabled()


# The weight-gradient sums of ResNet-18's f32 training convs as long as
# this (samples × output positions) or longer are summed in f64.
WGRAD_F64_MIN = 65_536
# The most bytes one f64 im2col copy of ``_RoundedResNetConv`` holds: it
# takes as many lanes at a time as fit, one at least.
F64_COLS_BYTES = 2 << 30


class _RoundedResNetConv(torch.autograd.Function):
    """ResNet-18's f32 training conv: the output summed in f64 and rounded
    once to f32; the input gradient is the library's f32 convolution of
    the saved f32 operands, and so is the weight gradient, but for a sum
    over ``WGRAD_F64_MIN`` terms or more, which is summed in f64 and
    rounded once.  The f64 sums are one batched GEMM a chunk of lanes
    over an f64 im2col copy of those lanes (``F64_COLS_BYTES`` at most),
    which the card runs on its f64 tensor cores; at ``baseline5``'s
    32×32 a lane's copy is 604 MB.

    Every ReLU of ResNet-18 follows a GroupNorm, whose outputs cluster
    about zero, and a ReLU routes each element's gradient by its sign:
    two devices whose f32 sums round apart route the elements nearest
    zero apart, and GroupNorm's backward spreads each such element over
    its group.  At ``baseline5``'s full size (32 lanes, batch 128) the
    card's step with the library's f32 convs was 2.9e-3 relative L2 from
    the CPU's, and each side 3.6-4.0e-3 from f64.  Summed in f64 and
    rounded once, a conv or GroupNorm of the same f32 inputs gives the
    same f32 result on any device, so the forward, and with it every
    ReLU's routing, is the same on the CPU and the card, and the f32
    backward is left to differ by its own rounding.  That rounding grows
    with the weight gradient's sum: cuDNN's f32 Winograd weight gradients
    of the 32×32 convs (batch 128 × 1,024 positions) were 1.3-2.2e-5
    relative L2 from the CPU's, so the longest sums take f64.  Its
    ``vmap`` rule folds a vmapped worker axis into the groups, as the
    stacked forward lays the workers' channels side by side."""

    @staticmethod
    def forward(z, weight, stride, padding, groups):
        b, co = z.shape[0], weight.shape[0] // groups
        hw = _RoundedResNetConv.out_hw(z, weight, stride, padding)
        out = z.new_empty(b, groups * co, *hw)
        ov = out.view(b, groups, co, -1)
        wv = weight.reshape(groups, co, -1)
        for lanes, cols in _RoundedResNetConv.lane_cols(
                z, weight.shape[-1], stride, padding, groups, hw):
            y = torch.bmm(wv[lanes].double(), cols)        # [n, co, B·L]
            ov[:, lanes].copy_(y.view(y.shape[0], co, b, -1)
                               .permute(2, 0, 1, 3))
        return out

    @staticmethod
    def out_hw(z, weight, stride, padding) -> tuple[int, int]:
        k = weight.shape[-1]
        pad = (padding,) * 2 if isinstance(padding, int) else padding
        return tuple((n + 2 * p - k) // stride + 1
                     for n, p in zip(z.shape[2:], pad))

    @staticmethod
    def lane_cols(z, k, stride, padding, groups, hw):
        """Yields ``(lanes, cols)`` over chunks of lanes: ``cols`` the f64
        im2col copy ``[n, C·k·k, B·Ho·Wo]`` of those lanes of
        worker-major ``z`` ``[B, G·C, H, W]``, rows in (c, kh, kw) order
        (the weight's), columns sample-major."""
        b, (h, w) = z.shape[0], z.shape[2:]
        c = z.shape[1] // groups
        ph, pw = (padding,) * 2 if isinstance(padding, int) else padding
        zv = z.reshape(b, groups, c, h, w)
        step = max(1, F64_COLS_BYTES // (8 * c * k * k * b * hw[0] * hw[1]))
        for l0 in range(0, groups, step):
            lanes = slice(l0, min(groups, l0 + step))
            xp = z.new_zeros((lanes.stop - l0, c, b, h + 2 * ph, w + 2 * pw),
                             dtype=torch.float64)
            xp[..., ph:ph + h, pw:pw + w].copy_(
                zv[:, lanes].permute(1, 2, 0, 3, 4))
            s = xp.stride()
            yield lanes, xp.as_strided(
                (xp.shape[0], c, k, k, b, *hw),
                (s[0], s[1], s[3], s[4], s[2], s[3] * stride,
                 s[4] * stride)).reshape(xp.shape[0], c * k * k, -1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        z, weight, stride, padding, groups = inputs
        ctx.save_for_backward(z, weight)
        ctx.conv = (stride, padding, groups)

    @staticmethod
    def backward(ctx, grad):
        z, weight = ctx.saved_tensors
        stride, padding, groups = ctx.conv
        gz = gw = None
        if ctx.needs_input_grad[0]:
            gz = torch.nn.grad.conv2d_input(z.shape, weight, grad,
                                            stride=stride, padding=padding,
                                            groups=groups)
        if not ctx.needs_input_grad[1]:
            return gz, gw, None, None, None
        b, co = grad.shape[0], weight.shape[0] // groups
        if b * grad[0, 0].numel() < WGRAD_F64_MIN:
            gw = torch.nn.grad.conv2d_weight(
                z, weight.shape, grad, stride=stride, padding=padding,
                groups=groups).contiguous()
            return gz, gw, None, None, None
        gw = torch.empty_like(weight, memory_format=torch.contiguous_format)
        gwv, gv = gw.view(groups, co, -1), grad.reshape(b, groups, co, -1)
        for lanes, cols in _RoundedResNetConv.lane_cols(
                z, weight.shape[-1], stride, padding, groups, grad.shape[2:]):
            g = gv[:, lanes].permute(1, 2, 0, 3).double().reshape(
                cols.shape[0], co, -1)
            gwv[lanes].copy_(torch.bmm(g, cols.transpose(1, 2)))
        return gz, gw, None, None, None

    @staticmethod
    def vmap(info, in_dims, z, weight, stride, padding, groups):
        v = info.batch_size
        z, weight = (
            t.movedim(d, 0) if d is not None else t.expand(v, *t.shape)
            for t, d in zip((z, weight), in_dims[:2]))
        b = z.shape[1]
        out = _RoundedResNetConv.apply(
            z.transpose(0, 1).reshape(b, -1, *z.shape[3:]),
            weight.reshape(-1, *weight.shape[2:]), stride, padding,
            v * groups)
        return out.view(b, v, -1, *out.shape[2:]), 1


class _RoundedGroupNorm(torch.autograd.Function):
    """``group_norm_stacked`` of ResNet-18's f32 training forward summed
    in f64 and rounded once to f32 (``_RoundedResNetConv`` says why):
    ``apply(z, scale, bias, groups, eps)`` on ``[B, C, H, W]`` and ``[C]``
    returns the output and the f64 ``[B, groups]`` mean and inverse
    deviation.  The group sums of z and z² accumulate in f64 from the
    f32 input, and the affine map z·a + c runs in f64 with f64 per-
    (sample, channel) coefficients, stored once to f32, in one pass.
    The backward is f32 elementwise with coefficients from f64 sums of
    the gradient and of gradient × input per (sample, channel).  Its
    ``vmap`` rule folds a vmapped worker axis into the groups, as the
    stacked forward lays the workers' channels side by side."""

    @staticmethod
    def forward(z, scale, bias, groups, eps):
        b, c = z.shape[:2]
        zg = z.reshape(b, groups, -1)
        n = zg.shape[-1]
        mean = zg.sum(-1, dtype=torch.float64) / n               # [b, g]
        sq = torch.linalg.vector_norm(zg, dim=-1, dtype=torch.float64)
        var = (sq * sq / n - mean * mean).clamp_min(0.0)
        inv = torch.rsqrt(var + eps)
        a = scale.double().view(1, groups, -1) * inv[..., None]
        c0 = bias.double().view(1, groups, -1) - mean[..., None] * a
        out = torch.empty_like(z, memory_format=torch.contiguous_format)
        torch.addcmul(c0.reshape(b, c, 1, 1), z, a.reshape(b, c, 1, 1),
                      out=out)
        return out, mean, inv

    @staticmethod
    def setup_context(ctx, inputs, output):
        z, scale, _, groups, _ = inputs
        _, mean, inv = output
        ctx.mark_non_differentiable(mean, inv)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(z, scale, mean, inv)
        ctx.groups = groups

    @staticmethod
    def backward(ctx, grad, _mean_grad, _inv_grad):
        z, scale, mean, inv = ctx.saved_tensors
        b, c = z.shape[:2]
        g = ctx.groups
        n = z[0].numel() // g
        q = grad.sum((2, 3), dtype=torch.float64).view(b, g, -1)  # Σ g
        p = (grad * z).sum((2, 3), dtype=torch.float64).view(b, g, -1)
        sc = scale.double().view(1, g, -1)
        mu, iv = mean[..., None], inv[..., None]
        gz = gs = gb = None
        if ctx.needs_input_grad[0]:
            # dL/dz = iv·(gy − mean(gy) − x̂·mean(gy·x̂)), gy = grad·scale,
            # as a·grad + bz·z + c0 per (sample, channel).
            s1 = (sc * q).sum(-1, keepdim=True) / n
            s2 = (sc * (p - mu * q)).sum(-1, keepdim=True) * iv / n
            a = (iv * sc).reshape(b, c, 1, 1).float()
            bz = (-iv * iv * s2).expand(b, g, c // g).reshape(
                b, c, 1, 1).float()
            c0 = (iv * (mu * iv * s2 - s1)).expand(b, g, c // g).reshape(
                b, c, 1, 1).float()
            gz = torch.addcmul(c0, bz, z).addcmul_(a, grad)
        if ctx.needs_input_grad[1]:
            gs = (iv * (p - mu * q)).sum(0).reshape(c).float()
        if ctx.needs_input_grad[2]:
            gb = q.sum(0).reshape(c).float()
        return gz, gs, gb, None, None

    @staticmethod
    def vmap(info, in_dims, z, scale, bias, groups, eps):
        v = info.batch_size
        z, scale, bias = (
            t.movedim(d, 0) if d is not None else t.expand(v, *t.shape)
            for t, d in zip((z, scale, bias), in_dims[:3]))
        b = z.shape[1]
        out, mean, inv = _RoundedGroupNorm.apply(
            z.transpose(0, 1).reshape(b, -1, *z.shape[3:]),
            scale.reshape(-1), bias.reshape(-1), v * groups, eps)
        return ((out.view(b, v, -1, *out.shape[2:]),
                 mean.view(b, v, groups), inv.view(b, v, groups)), (1, 1, 1))


def group_norm_stacked(z: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, *, num_workers: int,
                       groups_per_worker: int, eps: float = 1e-6
                       ) -> torch.Tensor:
    """flax ``GroupNorm`` over worker-major NCHW channels, dopt's
    ``_group_norm_stacked``: the ``W·g`` groups tile the workers'
    channel blocks, so no group spans two workers.  E[x] and E[x²]
    accumulate in f32 (the square taken in the compute dtype, as
    ``jnp.square`` is), ``var = max(E[x²] − E[x]², 0)``, and the
    normalisation is one ``z·a + c`` in ``z``'s dtype with
    per-(sample, channel) f32 coefficients cast to it, rounded as XLA
    rounds it: the trajectories are sensitive to that last rounding
    (an f32 ResNet-18's gradients moved 2.6e-4 relative between one
    rounding and two).  ``scale`` and ``bias`` are ``[W, C]``."""
    b, wc = z.shape[:2]
    g = num_workers * groups_per_worker
    zg = z.reshape(b, g, -1)
    mean = zg.mean(-1, dtype=torch.float32)                   # [b, g]
    mean2 = (zg * zg).mean(-1, dtype=torch.float32)
    inv = torch.rsqrt((mean2 - mean * mean).clamp_min(0.0) + eps)
    cpg = wc // g
    inv_c = inv.repeat_interleave(cpg, 1)                     # [b, wc]
    mean_c = mean.repeat_interleave(cpg, 1)
    sc = scale.reshape(1, wc).float()
    a = (sc * inv_c).to(z.dtype)
    c0 = (bias.reshape(1, wc).float() - mean_c * inv_c * sc).to(z.dtype)
    a, c0 = a[:, :, None, None], c0[:, :, None, None]
    if z.dtype == torch.float32:
        # One rounding, as XLA's contracted multiply-add.
        return torch.addcmul(c0, z, a)
    # Two roundings in bf16, as XLA's (bit for bit on the CPU).
    return (z * a).add_(c0)


def stacked_resnet_forward(params: dict[str, torch.Tensor], x: torch.Tensor,
                           *, faithful: bool,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ResNet-18's fleet forward (dopt's ``_make_stacked_resnet_apply``):
    NHWC ``[W, B, H, Wd, C]`` inputs → f32 ``[W, B, num_classes]``.  The
    depth is read off ``params``: ``ResidualBlock_k`` for k = 0, 1, …,
    and a block with a ``Conv_2`` projection strides 2 (``_resnet_shapes``).
    Every conv, GroupNorm and the head run in ``dtype``."""
    with _cpu_conv_flags(x):
        return _resnet_forward(params, x, faithful=faithful, dtype=dtype)


def _cpu_conv_flags(x: torch.Tensor):
    """NNPACK's fast CPU convs (batches of 16 and more) keep five digits
    (6e-6 relative against f64; 2e-7 without), which GroupNorm's
    E[x²] − E[x]² turns into 1e-3 on the gradients: off for a CPU
    ResNet forward."""
    if x.device.type == "cpu":
        return torch.backends.nnpack.flags(enabled=False)
    return contextlib.nullcontext()


def _gn(params, z, prefix, w, gpw):
    scale, bias = params[f"{prefix}.scale"], params[f"{prefix}.bias"]
    if _rounds_resnet(z.dtype):
        return _RoundedGroupNorm.apply(z, scale.reshape(-1),
                                       bias.reshape(-1), w * gpw, 1e-6)[0]
    return group_norm_stacked(z, scale, bias, num_workers=w,
                              groups_per_worker=gpw)


def _resnet_block(params, prefix: str, z: torch.Tensor, w: int, dtype,
                  stride: int) -> torch.Tensor:
    """dopt's ``ResidualBlock`` over worker-major NCHW channels: the
    block's tensors are ``{prefix}Conv_i.weight`` and
    ``{prefix}GroupNorm_i.{scale,bias}``, with the projection shortcut
    (``Conv_2``) where they hold one."""
    gpw = min(32, params[f"{prefix}Conv_0.weight"].shape[1])
    y = _resnet_conv(z, params[f"{prefix}Conv_0.weight"], w, dtype, stride)
    y = F.relu(_gn(params, y, f"{prefix}GroupNorm_0", w, gpw))
    y = _gn(params, _resnet_conv(y, params[f"{prefix}Conv_1.weight"], w,
                                 dtype), f"{prefix}GroupNorm_1", w, gpw)
    if f"{prefix}Conv_2.weight" in params:
        z = _gn(params, _resnet_conv(z, params[f"{prefix}Conv_2.weight"], w,
                                     dtype, stride),
                f"{prefix}GroupNorm_2", w, gpw)
    return F.relu(y + z)


def _resnet_forward(params, x, *, faithful, dtype):
    w, b, h, wd, c = x.shape
    z = x.to(dtype).permute(1, 0, 4, 2, 3).reshape(b, w * c, h, wd)
    z = F.relu(_gn(params, _resnet_conv(z, params["Conv_0.weight"], w,
                                        dtype), "GroupNorm_0", w, 32))
    k = 0
    while f"ResidualBlock_{k}.Conv_0.weight" in params:
        blk = f"ResidualBlock_{k}."
        z = _resnet_block(params, blk, z, w, dtype,
                          2 if f"{blk}Conv_2.weight" in params else 1)
        k += 1
    # Global mean pool, then the head over the worker axis in ``dtype``
    # (dopt zoo.py:428-434), feature-major as ``_stacked_linear`` takes it.
    z = z.mean((2, 3)).reshape(b, w, -1).permute(1, 2, 0)    # [W, C, B]
    z = _stacked_linear(z, params["head.weight"], params["head.bias"], dtype)
    z = z.transpose(1, 2).float()             # [W, B, num_classes]
    return torch.softmax(z, dim=-1) if faithful else z


def stacked_forward(name: str, params: dict[str, torch.Tensor],
                    x: torch.Tensor, *, faithful: bool,
                    dtype: torch.dtype = torch.float32,
                    impl: str = "auto") -> torch.Tensor:
    """The fleet's forward of zoo model ``name`` (``STACKED``):
    ``impl="auto"`` the worker-stacked program, ``"vmap"`` dopt's
    oracle-parity mode (``vmap_forward``)."""
    if name not in STACKED:
        raise ValueError(f"unknown model {name!r}; one of {sorted(STACKED)}")
    if impl == "vmap":
        return vmap_forward(name, params, x, faithful=faithful, dtype=dtype)
    if impl != "auto":
        raise ValueError(f"unknown stacked_impl {impl!r}; one of auto|vmap")
    if name == "resnet18":
        return stacked_resnet_forward(params, x, faithful=faithful,
                                      dtype=dtype)
    if name in _HIDDEN:
        return stacked_cnn_forward(params, x, faithful=faithful, dtype=dtype)
    return stacked_dense_forward(params, x, layers=LAYERS[name],
                                 faithful=faithful, dtype=dtype)


def vmap_forward(name: str, params: dict[str, torch.Tensor],
                 x: torch.Tensor, *, faithful: bool,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dopt's ``stacked_impl="vmap"`` (its ``vmap(model.apply)``): the
    worker's model — zoo model ``name`` for one worker, its parameters on
    the meta device — run by ``torch.func.functional_call`` on one
    worker's parameters and inputs, and ``torch.func.vmap`` over the
    worker axis of ``params`` and ``x``.  It computes what the stacked
    forward computes: vmap's batching rules fold the worker axis of a
    conv into its groups and of a dense layer into its batch, and on
    CUDA an f32 training conv and MLP hidden layer keep the card's rule
    (``_RoundedConv``, whose vmap rule folds it the same way;
    ``_RoundedLinear``, whose generated rule batches it)."""
    worker = StackedModel(name, {k: torch.empty((1, *v.shape[1:]),
                                                dtype=v.dtype, device="meta")
                                 for k, v in params.items()},
                          faithful=faithful, dtype=dtype)

    def one(p: dict[str, torch.Tensor], xi: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(
            worker, {k: v[None] for k, v in p.items()}, (xi[None],))[0]

    return torch.func.vmap(one)(dict(params), x)


def _register_nested(module: nn.Module, params: dict[str, torch.Tensor]
                     ) -> None:
    """Register each ``a.b.leaf`` tensor of ``params`` as a parameter of
    nested submodules, in sorted name order (dopt's flatten order)."""
    for key in sorted(params):
        *path, leaf = key.split(".")
        mod = module
        for part in path:
            if not hasattr(mod, part):
                mod.add_module(part, nn.Module())
            mod = getattr(mod, part)
        mod.register_parameter(leaf, nn.Parameter(params[key]))


class _Layer(nn.Module):
    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)


class StackedModel(nn.Module):
    """Zoo model ``name`` for a fleet of workers, built from a dict of
    ``[W, ...]`` tensors in ``param_shapes`` layout (stored in their own
    dtype) and computing in ``dtype``; its parameters are registered in
    ``LAYERS[name]`` order, ResNet-18's in sorted name order as nested
    modules (``ResidualBlock_0.Conv_0.weight``); ``impl`` is
    ``stacked_forward``'s (``ModelConfig.stacked_impl``).  Model1 has 1,663,370
    params a worker on 28×28×1, Model3 1,105,098 on 32×32×3, the MLP
    199,210 on 28×28×1, the logistic model 248 on a9a's 123 features and
    ResNet-18 11,173,962 on 32×32×3 (62 tensors)."""

    def __init__(self, name: str, params: dict[str, torch.Tensor], *,
                 faithful: bool, dtype: torch.dtype = torch.float32,
                 impl: str = "auto"):
        super().__init__()
        self.model_name = name
        self.faithful = faithful
        self.compute_dtype = dtype
        self.impl = impl
        if name == "resnet18":
            _register_nested(self, params)
            return
        for layer in LAYERS[name]:
            setattr(self, layer, _Layer(params[f"{layer}.weight"],
                                        params[f"{layer}.bias"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stacked_forward(self.model_name, dict(self.named_parameters()),
                               x, faithful=self.faithful,
                               dtype=self.compute_dtype, impl=self.impl)


class StackedCNN(StackedModel):
    """Model1 or Model3 (they differ only in fc1's width, which the
    params carry)."""

    def __init__(self, params: dict[str, torch.Tensor], *, faithful: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__("model1", params, faithful=faithful, dtype=dtype)


# -- one worker's models (dopt's flax modules) --------------------------------
# Each model's input when the caller names none: its presets' datasets
# (MNIST for Model1 and the MLP, CIFAR-10 for Model3 and ResNet-18, a9a's
# 123 features for the logistic model).
DEFAULT_INPUT_SHAPE = {"model1": (28, 28, 1), "model3": (32, 32, 3),
                       "mlp": (28, 28, 1), "logistic": (123,),
                       "resnet18": (32, 32, 3)}
# The port's compute and storage dtypes, by name.
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype) -> torch.dtype:
    """A compute dtype by torch dtype or by name (dopt's ``dtype=`` takes
    a string too); the port computes in f32 or bf16."""
    if isinstance(dtype, str):
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}; one of "
                             f"{'|'.join(COMPUTE_DTYPES)}")
        return COMPUTE_DTYPES[dtype]
    if dtype not in COMPUTE_DTYPES.values():
        raise ValueError(f"unsupported compute dtype {dtype}; the port "
                         "computes in float32 or bfloat16")
    return dtype


def _placed(params: dict[str, torch.Tensor], device) -> dict:
    """``params`` on the port's device (``resolve_device``: the GPU unless
    the caller names the CPU)."""
    from dopt_torch.engine.gossip import resolve_device

    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in params.items()}


class _WorkerModel(nn.Module):
    """One worker of a zoo model: the one-lane case of
    ``stacked_forward`` over this module's parameters, so each model's
    arithmetic (the rounded layers of ``ROUNDED_F64`` among it) lives in
    one place.  Built with flax's default init drawn from
    ``generator`` on the CPU (``init_worker_params``), then placed on
    ``device``.  Input NHWC ``[B, H, W, C]`` (``[B, D]`` rows for the
    dense models); output f32 ``[B, num_classes]``, probabilities when
    faithful.  ``load_jax_params``/``jax_params`` carry one worker's
    dopt flax params across (``dopt_torch.convert``)."""

    model_name = ""
    default_faithful = False

    def __init__(self, num_classes: int = 10, faithful: bool | None = None,
                 dtype=torch.float32, *, input_shape=None, stage_sizes=None,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        name = self.model_name
        self.num_classes = num_classes
        self.faithful = (self.default_faithful if faithful is None
                         else faithful)
        self.compute_dtype = compute_dtype(dtype)
        self.input_shape = tuple(input_shape or DEFAULT_INPUT_SHAPE[name])
        params = _placed(init_worker_params(
            name, num_classes=num_classes, input_shape=self.input_shape,
            generator=generator, stage_sizes=stage_sizes), device)
        if name == "resnet18":
            _register_nested(self, params)
        else:
            for layer in LAYERS[name]:
                setattr(self, layer, _Layer(params[f"{layer}.weight"],
                                            params[f"{layer}.bias"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = {k: v.unsqueeze(0) for k, v in self.named_parameters()}
        return stacked_forward(self.model_name, p, x.unsqueeze(0),
                               faithful=self.faithful,
                               dtype=self.compute_dtype)[0]

    @torch.no_grad()
    def load_jax_params(self, tree) -> "_WorkerModel":
        """Copy one worker's dopt flax params (``model.init(...)``'s tree,
        with or without its ``"params"`` level; numpy or jax leaves) into
        this module, in place; returns the module."""
        from dopt_torch.convert import params_from_jax

        if set(tree) == {"params"}:
            tree = tree["params"]
        got = params_from_jax(tree, input_shape=self.input_shape)
        own = dict(self.named_parameters())
        if got.keys() != own.keys():
            raise ValueError(f"the flax tree's leaves {sorted(got)} are not "
                             f"{self.model_name}'s {sorted(own)}")
        for k, v in own.items():
            if tuple(got[k].shape) != tuple(v.shape):
                raise ValueError(f"{k}: the flax leaf has shape "
                                 f"{tuple(got[k].shape)}, the module "
                                 f"{tuple(v.shape)}")
            v.copy_(torch.from_numpy(got[k]))
        return self

    def jax_params(self) -> dict:
        """This worker's parameters as dopt's flax tree (numpy leaves, as
        ``model.init`` returns them under ``"params"``)."""
        from dopt_torch.convert import params_to_jax

        return {"params": params_to_jax(dict(self.named_parameters()),
                                        input_shape=self.input_shape)}


class Model1(_WorkerModel):
    """The MNIST/FMNIST CNN (the reference's ``models.py:6-27``),
    1,663,370 params on 28×28×1; the faithful double-softmax head by
    default."""

    model_name = "model1"
    default_faithful = True


class Model3(_WorkerModel):
    """The CIFAR CNN (the reference's ``models.py:31-51``), 1,105,098
    params on 32×32×3 at 10 classes; faithful by default."""

    model_name = "model3"
    default_faithful = True


class MLP(_WorkerModel):
    """The 2×200 MLP (BASELINE.json config 1), 199,210 params on
    28×28×1."""

    model_name = "mlp"


class LogisticRegression(_WorkerModel):
    """ℓ2-regularised logistic regression (BASELINE.json config 4) on
    a9a's 123 features; the ℓ2 term lives in the loss
    (``losses.l2_regulariser``).  dopt's default is 2 classes."""

    model_name = "logistic"

    def __init__(self, num_classes: int = 2, faithful: bool | None = None,
                 dtype=torch.float32, **kw):
        super().__init__(num_classes, faithful, dtype, **kw)


class ResNet18(_WorkerModel):
    """dopt's CIFAR-style GroupNorm ResNet-18 (BASELINE.json config 5),
    11,173,962 params in 62 tensors on 32×32×3; ``stage_sizes`` its
    block count a stage ((2, 2, 2, 2) by default).  Parameters carry
    dopt's nested names dotted (``ResidualBlock_0.Conv_0.weight``)."""

    model_name = "resnet18"

    def __init__(self, num_classes: int = 10, faithful: bool | None = None,
                 dtype=torch.float32, stage_sizes=RESNET_STAGES, **kw):
        super().__init__(num_classes, faithful, dtype,
                         stage_sizes=tuple(stage_sizes), **kw)


class ResidualBlock(nn.Module):
    """dopt's ``ResidualBlock`` alone: 3×3 conv (stride ``strides``) →
    GroupNorm → ReLU → 3×3 conv → GroupNorm, plus the input, through a
    1×1 conv and GroupNorm where the shape changes, then ReLU; no bias,
    ``min(32, features)`` groups.  flax reads the input channels off the
    first call; a torch module needs them at construction
    (``in_features``, ``features`` by default).  NHWC in and out; the
    block ``ResNet18`` runs (``_resnet_block``)."""

    def __init__(self, features: int, strides: int = 1, dtype=torch.float32,
                 *, in_features: int | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        cin = in_features or features
        self.strides = strides
        self.compute_dtype = compute_dtype(dtype)
        convs = [(features, cin, 3, 3), (features, features, 3, 3)]
        if strides != 1 or cin != features:
            convs.append((features, cin, 1, 1))
        params = {}
        for i, shape in enumerate(convs):
            w = torch.zeros(shape)
            _lecun_normal_(w, generator)
            params[f"Conv_{i}.weight"] = w
            params[f"GroupNorm_{i}.scale"] = torch.ones(features)
            params[f"GroupNorm_{i}.bias"] = torch.zeros(features)
        _register_nested(self, _placed(params, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = {k: v.unsqueeze(0) for k, v in self.named_parameters()}
        with _cpu_conv_flags(x):
            z = _resnet_block(p, "", x.to(self.compute_dtype).permute(
                0, 3, 1, 2), 1, self.compute_dtype, self.strides)
        return z.permute(0, 2, 3, 1)


def _transformer(num_classes: int = 256, faithful: bool | None = None,
                 dtype=torch.float32, *, input_shape=None, device=None,
                 generator: torch.Generator | None = None) -> nn.Module:
    """dopt's ``TransformerLM`` at its defaults (dim 128, depth 2, 4
    heads, max_len 2048), ``num_classes`` its vocabulary."""
    if input_shape is not None:
        raise ValueError("input_shape applies to the image and tabular "
                         "models, not the transformer")
    params = _placed(init_transformer_params(vocab=num_classes,
                                             generator=generator), device)
    return TransformerLM(params, heads=4, dtype=compute_dtype(dtype),
                         faithful=bool(faithful))


def build_model(name: str, *, num_classes: int = 10,
                faithful: bool | None = None, dtype=torch.float32,
                stage_sizes=None, input_shape=None, device=None,
                generator: torch.Generator | None = None) -> nn.Module:
    """Model dispatch by name, dopt's ``build_model``: one worker's model,
    initialised (flax's defaults from ``generator``) on ``device`` (the
    GPU unless the caller names the CPU).  ``faithful=None`` keeps each
    model's default (True for the reference CNNs only); ``dtype`` (a
    torch dtype or its name) is the compute dtype, the parameters stay
    f32; ``stage_sizes`` is ResNet-18's only.  ``input_shape`` is the
    port's own: a torch module needs its shapes at construction, where
    flax reads them off the first call (default ``DEFAULT_INPUT_SHAPE``)."""
    key = name.lower()
    if key not in _ZOO:
        raise ValueError(f"unknown model {name!r}; one of {sorted(_ZOO)}")
    kwargs: dict = dict(num_classes=num_classes, dtype=dtype, device=device,
                        generator=generator)
    if faithful is not None:
        kwargs["faithful"] = faithful
    if stage_sizes is not None:
        if key != "resnet18":
            raise ValueError("stage_sizes applies to resnet18 only")
        kwargs["stage_sizes"] = tuple(stage_sizes)
    if input_shape is not None:
        kwargs["input_shape"] = tuple(input_shape)
    return _ZOO[key](**kwargs)


# -- the sequence model -----------------------------------------------------
def transformer_shapes(*, vocab: int, dim: int = 128, depth: int = 2,
                       max_len: int = 2048) -> dict[str, tuple[int, ...]]:
    """TransformerLM's parameter shapes in sorted name order: the
    embedding table ``tok_emb.weight`` [vocab, dim] (also the tied output
    head), ``pos_emb`` [max_len, dim], and per block i the LayerNorms
    ``ln1_i``/``ln2_i`` (``scale``, ``bias``), the bias-free ``qkv_i``
    [3·dim, dim] and ``proj_i`` [dim, dim], the MLP's ``up_i`` [4·dim,
    dim] and ``down_i`` [dim, 4·dim] with biases, and ``ln_f``.  Dense
    weights are torch's ``[out, in]``."""
    shapes = {"tok_emb.weight": (vocab, dim), "pos_emb": (max_len, dim),
              "ln_f.scale": (dim,), "ln_f.bias": (dim,)}
    for i in range(depth):
        for ln in (f"ln1_{i}", f"ln2_{i}"):
            shapes[f"{ln}.scale"] = (dim,)
            shapes[f"{ln}.bias"] = (dim,)
        shapes[f"qkv_{i}.weight"] = (3 * dim, dim)
        shapes[f"proj_{i}.weight"] = (dim, dim)
        shapes[f"up_{i}.weight"] = (4 * dim, dim)
        shapes[f"up_{i}.bias"] = (4 * dim,)
        shapes[f"down_{i}.weight"] = (dim, 4 * dim)
        shapes[f"down_{i}.bias"] = (dim,)
    return {k: shapes[k] for k in sorted(shapes)}


def init_transformer_params(*, vocab: int, dim: int = 128, depth: int = 2,
                            max_len: int = 2048,
                            generator: torch.Generator | None = None
                            ) -> dict[str, torch.Tensor]:
    """TransformerLM's init with flax's defaults, drawn on the CPU in
    sorted name order: dense weights LeCun-normal (normal truncated at
    ±2σ, σ = √(1/fan_in)/0.8796…), the embedding table normal with σ =
    √(1/dim) (flax's ``Embed`` default), ``pos_emb`` normal(0.02),
    LayerNorm scales one and every bias zero."""
    out = {}
    for key, shape in transformer_shapes(vocab=vocab, dim=dim, depth=depth,
                                         max_len=max_len).items():
        t = torch.zeros(shape, dtype=torch.float32)
        if key.endswith("scale"):
            t.fill_(1.0)
        elif key == "tok_emb.weight":
            t.normal_(0.0, math.sqrt(1.0 / dim), generator=generator)
        elif key == "pos_emb":
            t.normal_(0.0, 0.02, generator=generator)
        elif key.endswith("weight"):
            std = math.sqrt(1.0 / shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        out[key] = t
    return out


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """flax ``LayerNorm`` over the last axis: the statistics in f32 (var =
    max(E[x²] − E[x]², 0)), y = (x − mean)·(rsqrt(var + eps)·scale) +
    bias in f32, cast to ``x``'s dtype.  flax's epsilon is 1e-6
    (``nn.LayerNorm``'s is 1e-5)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    return ((xf - mean) * mul + bias.float()).to(x.dtype)


class TransformerLM(nn.Module):
    """dopt's decoder-only TransformerLM (pre-LN blocks, learned
    positional embeddings, weight-tied output head) as one model with no
    worker axis, built from a ``transformer_shapes`` dict of f32 tensors
    registered in sorted name order.  ``forward(tokens, attn_fn,
    offset)`` takes this rank's ``[B, Lb]`` int tokens, whose first
    position is global position ``offset`` (its ``pos_emb`` rows are
    ``[offset, offset + Lb)``), and returns ``[B, Lb, vocab]`` logits in
    the compute dtype.  ``attn_fn(q, k, v)`` on ``[B, Lb, H, Dh]`` is the
    attention (``dopt_torch.parallel.sequence``); None is one rank's
    dense causal attention.

    As in dopt: qkv is split in three along the head axis of
    ``[B, L, 3·H, Dh]`` (q is the first H heads), qkv and proj have no
    bias, GELU is the tanh approximation (flax's ``nn.gelu`` default),
    and LayerNorm's epsilon is flax's 1e-6.  bf16 compute casts where
    dopt's ``dtype=`` casts: the table and every weight and bias go to
    bf16, the LayerNorms compute in f32 and return bf16, and the logits
    are bf16; the parameters stay f32.  The token lookup is a one-hot
    product with the table: on CUDA its backward is a GEMM, which the
    deterministic mode allows, where the embedding's backward would
    accumulate rows by atomics."""

    def __init__(self, params: dict[str, torch.Tensor], *, heads: int,
                 dtype: torch.dtype = torch.float32, faithful: bool = False):
        super().__init__()
        self.faithful = faithful
        self.vocab, self.dim = params["tok_emb.weight"].shape
        self.max_len = params["pos_emb"].shape[0]
        self.depth = sum(k.startswith("qkv_") for k in params)
        self.heads = heads
        self.compute_dtype = dtype
        _register_nested(self, params)

    def forward(self, tokens: torch.Tensor, attn_fn=None,
                offset: int = 0) -> torch.Tensor:
        from dopt_torch.parallel.sequence import dense_attention

        attn = attn_fn or (lambda q, k, v: dense_attention(q, k, v,
                                                           causal=True))
        b, l = tokens.shape
        if offset + l > self.max_len:
            raise ValueError(f"sequence length {offset + l} > max_len "
                             f"{self.max_len}")
        if self.dim % self.heads:
            raise ValueError(f"dim {self.dim} not divisible by "
                             f"heads {self.heads}")
        dt, hd = self.compute_dtype, self.dim // self.heads
        p = dict(self.named_parameters())
        emb = p["tok_emb.weight"].to(dt)
        hot = tokens[..., None] == torch.arange(self.vocab,
                                                device=tokens.device)
        x = hot.to(dt) @ emb
        x = x + p["pos_emb"][offset:offset + l].to(dt)
        for i in range(self.depth):
            y = layer_norm(x, p[f"ln1_{i}.scale"], p[f"ln1_{i}.bias"])
            qkv = F.linear(y, p[f"qkv_{i}.weight"].to(dt))
            q, k, v = qkv.view(b, l, 3 * self.heads, hd).split(self.heads,
                                                               dim=2)
            o = attn(q, k, v).reshape(b, l, self.dim)
            x = x + F.linear(o, p[f"proj_{i}.weight"].to(dt))
            y = layer_norm(x, p[f"ln2_{i}.scale"], p[f"ln2_{i}.bias"])
            y = F.linear(y, p[f"up_{i}.weight"].to(dt),
                         p[f"up_{i}.bias"].to(dt))
            y = F.gelu(y, approximate="tanh")
            x = x + F.linear(y, p[f"down_{i}.weight"].to(dt),
                             p[f"down_{i}.bias"].to(dt))
        x = layer_norm(x, p["ln_f.scale"], p["ln_f.bias"])
        logits = x @ emb.t()
        return torch.softmax(logits.float(), -1) if self.faithful else logits


# dopt's ``_ZOO``: every model ``build_model`` builds, by name.
_ZOO = {"model1": Model1, "model3": Model3, "mlp": MLP,
        "logistic": LogisticRegression, "resnet18": ResNet18,
        "transformer": _transformer}


def count_params(params) -> int:
    """The number of parameters of a dict of tensors or arrays (nested
    dicts too, as dopt's flax trees) or of a module."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(count_params(v) if isinstance(v, dict) else math.prod(v.shape)
               for v in params.values())
