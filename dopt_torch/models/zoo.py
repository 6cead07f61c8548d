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
sum does (``ROUNDED_F64``: a model rounds one kind of layer).

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


# The port's f64 tensor work: each model's layer that the card sums in
# f64 and rounds once in f32 training, and the device-time phase its f64
# kernels belong to.  A kernel's name cannot tell a conv's f64 GEMM from
# a dense layer's, so a model rounds one kind of layer, and
# ``utils.profiling.device_stats_of(model=...)`` files the f64 kernels of
# a window by this table (tests/test_torch_profiling.py holds the
# package's f64 sites to its classes).
ROUNDED_F64 = {"model1": ("_RoundedConv", "conv"),
               "model3": ("_RoundedConv", "conv"),
               "mlp": ("_RoundedLinear", "other")}


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
    uneven 'SAME' padding is applied explicitly first."""
    k = weight.shape[-1]
    (ht, hb), (wl, wr) = (_same_pad(n, k, stride) for n in z.shape[2:])
    if ht == hb and wl == wr:
        pad = (ht, wl)
    else:
        z, pad = F.pad(z, (wl, wr, ht, hb)), 0
    return F.conv2d(z, weight.reshape(-1, *weight.shape[2:]).to(dtype),
                    stride=stride, padding=pad, groups=groups)


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
    if x.device.type == "cpu":
        # NNPACK's fast CPU convs (batches of 16 and more) keep five
        # digits (6e-6 relative against f64; 2e-7 without), which
        # GroupNorm's E[x²] − E[x]² turns into 1e-3 on the gradients.
        with torch.backends.nnpack.flags(enabled=False):
            return _resnet_forward(params, x, faithful=faithful, dtype=dtype)
    return _resnet_forward(params, x, faithful=faithful, dtype=dtype)


def _resnet_forward(params, x, *, faithful, dtype):
    w, b, h, wd, c = x.shape
    z = x.to(dtype).permute(1, 0, 4, 2, 3).reshape(b, w * c, h, wd)

    def gn(z, prefix, gpw):
        return group_norm_stacked(z, params[f"{prefix}.scale"],
                                  params[f"{prefix}.bias"], num_workers=w,
                                  groups_per_worker=gpw)

    z = F.relu(gn(_resnet_conv(z, params["Conv_0.weight"], w, dtype),
                  "GroupNorm_0", 32))
    k = 0
    while f"ResidualBlock_{k}.Conv_0.weight" in params:
        blk = f"ResidualBlock_{k}"
        proj = f"{blk}.Conv_2.weight" in params
        stride = 2 if proj else 1
        gpw = min(32, params[f"{blk}.Conv_0.weight"].shape[1])
        y = _resnet_conv(z, params[f"{blk}.Conv_0.weight"], w, dtype, stride)
        y = F.relu(gn(y, f"{blk}.GroupNorm_0", gpw))
        y = gn(_resnet_conv(y, params[f"{blk}.Conv_1.weight"], w, dtype),
               f"{blk}.GroupNorm_1", gpw)
        if proj:
            z = gn(_resnet_conv(z, params[f"{blk}.Conv_2.weight"], w, dtype,
                                stride), f"{blk}.GroupNorm_2", gpw)
        z = F.relu(y + z)
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
                 dtype: torch.dtype = torch.float32):
        super().__init__()
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
        return x @ emb.t()


def count_params(params) -> int:
    """The number of parameters of a dict of tensors or arrays (nested
    dicts too, as dopt's flax trees) or of a module."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(count_params(v) if isinstance(v, dict) else math.prod(v.shape)
               for v in params.values())
