"""The sequential reference oracle: one torch model a worker.

The port's copy of dopt/engine/oracle.py — an implementation of the
reference's training numerics written apart from the port's stacked
engines, and the ground truth they are held against:

* Models: the reference CNNs (conv stack with NO activations, ReLU only
  between the dense layers, a softmax head when faithful), the MLP and
  the logistic model as plain ``nn.Module`` twins in NCHW
  (``torch_reference_cnn``, ``torch_mlp``, ``torch_logistic``;
  dopt :52-122).
* Local update: a persistent ``torch.optim.SGD(lr, momentum)`` a worker
  over the same batch plan the engines consume; FedProx and FedADMM edit
  ``param.grad`` in place as the reference does, FedADMM keeps its dual
  and SCAFFOLD its control variate (``OracleWorker``, dopt :222-378).
* Consensus: the weighted state-dict sum w_i ← Σ_j a_ij w_j, with no
  implicit self term (``consensus``, dopt :379).

Devices and randomness are explicit: a twin is built on the device the
caller names (the CPU when None), its parameters drawn from the
``torch.Generator`` the caller passes (flax's defaults: LeCun-normal
weights truncated at ±2σ, zero biases) or left zero for a state to be
loaded; nothing reads torch's global RNG.

Layouts.  The port's parameter layout (``dopt_torch.convert``) is the
twins' state dict under the same names: conv ``[Cout, Cin, kh, kw]``,
dense ``[out, in]``, the CNN's fc1 input in CHW order (the reference
flattens NCHW), the MLP's and the logistic model's input in HWC order,
which is the twins' flatten order for one channel (the only case they
take).  ``port_to_twin`` and ``twin_to_port`` copy between them.  dopt's
flax trees come in through ``flax_cnn_params_to_torch`` and
``flax_dense_params_to_torch`` (dopt :126-191): flax kernels are
``[kh, kw, Cin, Cout]`` and ``[in, out]``, and the first dense layer's
rows are reordered from flax's HWC flatten to the reference's CHW
(``_fc1_to_torch``)."""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


# -- the twins (NCHW) ---------------------------------------------------
def _materialize(module: nn.Module, device=None,
                 generator: torch.Generator | None = None) -> nn.Module:
    """A twin built on the meta device, placed on ``device`` with flax's
    default init drawn from ``generator`` on the CPU (weights in
    registration order), or zero-filled when there is none."""
    module = module.to_empty(device=torch.device(device or "cpu"))
    with torch.no_grad():
        for name, p in module.named_parameters():
            t = torch.zeros(p.shape, dtype=p.dtype)
            if generator is not None and name.endswith("weight"):
                std = (math.sqrt(1.0 / math.prod(p.shape[1:]))
                       / 0.87962566103423978)
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            p.copy_(t)
    return module


def torch_reference_cnn(in_channels: int, spatial: int, hidden: int,
                        num_classes: int = 10, faithful: bool = True, *,
                        device=None, generator=None) -> nn.Module:
    """The reference CNN: conv(k5, p2) → pool → conv(k5, p2) → pool →
    Dense(hidden) → ReLU → Dense(classes) [→ Softmax]."""
    flat = (spatial // 4) ** 2 * 64

    class _Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(in_channels, 32, 5, padding=2,
                                   device="meta")
            self.conv2 = nn.Conv2d(32, 64, 5, padding=2, device="meta")
            self.fc1 = nn.Linear(flat, hidden, device="meta")
            self.fc2 = nn.Linear(hidden, num_classes, device="meta")

        def forward(self, x):
            x = self.conv1(x)
            if not faithful:
                x = F.relu(x)
            x = F.max_pool2d(x, 2)
            x = self.conv2(x)
            if not faithful:
                x = F.relu(x)
            x = F.max_pool2d(x, 2)
            x = x.reshape(x.shape[0], -1)
            x = F.relu(self.fc1(x))
            x = self.fc2(x)
            return F.softmax(x, dim=-1) if faithful else x

    return _materialize(_Net(), device, generator)


def torch_mlp(flat: int, hidden=(200, 200), num_classes: int = 10,
              faithful: bool = False, *, device=None,
              generator=None) -> nn.Module:
    """Twin of dopt's ``MLP`` (the port's ``fc1``, ``fc2``, ``head``).
    Input NCHW; only one channel (or flat rows) flattens as the port's
    HWC order does."""

    class _MLP(nn.Module):
        def __init__(self):
            super().__init__()
            dims = [flat, *hidden]
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
                setattr(self, f"fc{i + 1}", nn.Linear(a, b, device="meta"))
            self.head = nn.Linear(dims[-1], num_classes, device="meta")
            self.n_hidden = len(hidden)

        def forward(self, x):
            x = x.reshape(x.shape[0], -1)
            for i in range(self.n_hidden):
                x = F.relu(getattr(self, f"fc{i + 1}")(x))
            x = self.head(x)
            return F.softmax(x, dim=-1) if faithful else x

    return _materialize(_MLP(), device, generator)


def torch_logistic(flat: int, num_classes: int = 2, faithful: bool = False,
                   *, device=None, generator=None) -> nn.Module:
    """Twin of dopt's ``LogisticRegression`` (the port's ``linear``)."""

    class _Log(nn.Module):
        def __init__(self):
            super().__init__()
            self.linear = nn.Linear(flat, num_classes, device="meta")

        def forward(self, x):
            x = self.linear(x.reshape(x.shape[0], -1))
            return F.softmax(x, dim=-1) if faithful else x

    return _materialize(_Log(), device, generator)


# -- layouts ------------------------------------------------------------
def port_to_twin(params: Mapping, device=None) -> dict[str, torch.Tensor]:
    """One worker's port parameters (tensors or arrays) → a twin's state
    dict: the same names and layouts, as fresh f32 tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).detach().float().clone().to(
        torch.device(device or "cpu")) for k, v in params.items()}


def twin_to_port(state: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A twin's state dict → the port's parameter dict as numpy arrays
    (``dopt_torch.convert.params_to_jax`` takes it to dopt's tree)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def _conv_to_torch(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))  # [H,W,I,O] -> [O,I,H,W]


def _dense_to_torch(k: np.ndarray) -> np.ndarray:
    return np.transpose(k)  # [in,out] -> [out,in]


def _fc1_to_torch(k: np.ndarray, spatial: int,
                  channels: int = 64) -> np.ndarray:
    """First dense layer after the flatten: reorder flax's HWC input
    rows to the reference's CHW before transposing."""
    s = spatial // 4
    out = k.shape[1]
    k = k.reshape(s, s, channels, out)          # [H,W,C,out]
    k = np.transpose(k, (2, 0, 1, 3))           # [C,H,W,out]
    return np.transpose(k.reshape(s * s * channels, out))  # [out, CHW]


def _flatten2(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else f"{k}"
        if isinstance(v, Mapping):
            out.update(_flatten2(v, key))
        else:
            out[key] = v
    return out


def flax_cnn_params_to_torch(params: Mapping, spatial: int
                             ) -> dict[str, torch.Tensor]:
    """dopt's Model1/Model3 flax tree (numpy leaves) → the reference
    CNN twin's state dict."""
    t = torch.from_numpy
    p = {k: np.asarray(v) for k, v in _flatten2(params).items()}
    return {
        "conv1.weight": t(_conv_to_torch(p["conv1.kernel"]).copy()),
        "conv1.bias": t(p["conv1.bias"].copy()),
        "conv2.weight": t(_conv_to_torch(p["conv2.kernel"]).copy()),
        "conv2.bias": t(p["conv2.bias"].copy()),
        "fc1.weight": t(_fc1_to_torch(p["fc1.kernel"], spatial).copy()),
        "fc1.bias": t(p["fc1.bias"].copy()),
        "fc2.weight": t(_dense_to_torch(p["fc2.kernel"]).copy()),
        "fc2.bias": t(p["fc2.bias"].copy()),
    }


def torch_cnn_params_to_flax(state: Mapping[str, torch.Tensor],
                             spatial: int) -> dict:
    """Inverse of ``flax_cnn_params_to_torch``."""
    s = spatial // 4

    def fc1_to_flax(w: np.ndarray) -> np.ndarray:
        out = w.shape[0]
        k = w.T.reshape(64, s, s, out)          # [C,H,W,out]
        k = np.transpose(k, (1, 2, 0, 3))       # [H,W,C,out]
        return k.reshape(s * s * 64, out)

    g = {k: v.detach().cpu().numpy() for k, v in state.items()}
    return {
        "conv1": {"kernel": np.transpose(g["conv1.weight"], (2, 3, 1, 0)),
                  "bias": g["conv1.bias"]},
        "conv2": {"kernel": np.transpose(g["conv2.weight"], (2, 3, 1, 0)),
                  "bias": g["conv2.bias"]},
        "fc1": {"kernel": fc1_to_flax(g["fc1.weight"]), "bias": g["fc1.bias"]},
        "fc2": {"kernel": np.transpose(g["fc2.weight"]), "bias": g["fc2.bias"]},
    }


def flax_dense_params_to_torch(params: Mapping) -> dict[str, torch.Tensor]:
    """A dense-only flax tree {name: {kernel, bias}} → a twin's state
    dict {name.weight, name.bias} (kernel [in, out] → weight [out, in])."""
    out = {}
    for name, leaf in params.items():
        out[f"{name}.weight"] = torch.from_numpy(
            np.asarray(leaf["kernel"]).T.copy())
        out[f"{name}.bias"] = torch.from_numpy(
            np.asarray(leaf["bias"]).copy())
    return out


def torch_dense_params_to_flax(state: Mapping) -> dict:
    """Inverse of ``flax_dense_params_to_torch``."""
    out: dict = {}
    for key, v in state.items():
        name, kind = key.rsplit(".", 1)
        leaf = out.setdefault(name, {})
        arr = v.detach().cpu().numpy()
        leaf["kernel" if kind == "weight" else "bias"] = (
            arr.T.copy() if kind == "weight" else arr.copy())
    return out


def nhwc_to_nchw(x: np.ndarray) -> np.ndarray:
    """Batch-plan features [..., H, W, C] → [..., C, H, W]."""
    return np.moveaxis(x, -1, -3)


# -- the worker ---------------------------------------------------------
class OracleWorker:
    """One reference client: a model and its persistent SGD optimizer,
    whose momentum buffers survive consensus and theta loads (the
    reference's ``Client`` creates its optimizer once).  The model's
    device is the worker's: each batch stack goes there once a call, and
    the per-step losses and counts stay there until the call's end."""

    def __init__(self, model: nn.Module, *, lr: float, momentum: float,
                 rho: float = 0.0, algorithm: str = "sgd", l2: float = 0.0):
        self.model = model
        self.device = next(model.parameters()).device
        self.optimizer = torch.optim.SGD(model.parameters(), lr=lr,
                                         momentum=momentum)
        self.rho = rho
        self.l2 = l2  # the explicit λ‖θ‖²/2 loss term (dopt's l2)
        self.algorithm = algorithm
        if algorithm == "fedadmm":
            self.alpha = {n: torch.zeros_like(p)
                          for n, p in model.named_parameters()}
        if algorithm == "scaffold":
            # The client control variate c_i.
            self.control = {n: torch.zeros_like(p)
                            for n, p in model.named_parameters()}

    def load(self, state: Mapping[str, torch.Tensor]) -> None:
        self.model.load_state_dict({k: v.clone() for k, v in state.items()})

    def state(self) -> dict[str, torch.Tensor]:
        return {k: v.clone() for k, v in self.model.state_dict().items()}

    def _stack(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return t if dtype is None else t.to(dtype)

    def local_update(self, bx: np.ndarray, by: np.ndarray, bw: np.ndarray,
                     theta: Mapping | None = None,
                     c_global: Mapping | None = None) -> float:
        """The batch plan's steps: bx [S, B, C, H, W] (NCHW), by [S, B],
        bw [S, B] padding weights.  Returns the mean loss."""
        if self.algorithm == "scaffold" and c_global is None:
            raise ValueError("scaffold local_update requires c_global")
        losses: list[float] = []
        self._epoch_steps(bx, by, bw, theta, c_global, losses, [0.0, 0.0])
        return float(np.mean(losses))

    def inference(self, bx: np.ndarray, by: np.ndarray,
                  bw: np.ndarray) -> tuple[float, float, float]:
        """The reference's ``Client.inference`` over a static [S, B, ...]
        NCHW eval stack: (accuracy, the summed batch losses [P1's
        flavour], their mean [P2's]); padding rows weigh 0."""
        self.model.eval()
        x, y, w = self._stack(bx), self._stack(by, torch.long), self._stack(bw)
        losses, correct, total = [], [], []
        with torch.no_grad():
            for s in range(x.shape[0]):
                out = self.model(x[s])
                per = F.cross_entropy(out, y[s], reduction="none")
                losses.append((per * w[s]).sum() / w[s].sum().clamp(min=1.0))
                pred = out.argmax(dim=1)
                correct.append(((pred == y[s]).float() * w[s]).sum())
                total.append(w[s].sum())
        self.model.train()
        losses = _host_floats(losses)
        acc = _running_sum(_host_floats(correct)) / max(
            _running_sum(_host_floats(total)), 1.0)
        return acc, float(np.sum(losses)), float(np.mean(losses))

    def local_update_epochs(self, bx, by, bw, vx, vy, vw,
                            theta: Mapping | None = None,
                            c_global: Mapping | None = None,
                            val_flavor: str = "mean") -> list[dict]:
        """The reference's epoch-structured local update: bx is
        [E, S', B, ...] epoch-major; after each epoch's steps the local
        validation stack (vx, vy, vw) is evaluated and a row
        {epoch, train_loss, train_acc, val_acc, val_loss} recorded
        (val_loss in P1's 'sum' or P2's 'mean' flavour)."""
        if self.algorithm == "scaffold" and c_global is None:
            raise ValueError("scaffold local_update requires c_global")
        rows = []
        for e in range(bx.shape[0]):
            correct_total = [0.0, 0.0]
            losses: list[float] = []
            loss_mean = self._epoch_steps(bx[e], by[e], bw[e], theta,
                                          c_global, losses, correct_total)
            vacc, vsum, vmean = self.inference(vx, vy, vw)
            rows.append({
                "epoch": e,
                "train_loss": loss_mean,
                "train_acc": correct_total[0] / max(correct_total[1], 1.0),
                "val_acc": vacc,
                "val_loss": vsum if val_flavor == "sum" else vmean,
            })
        return rows

    def _epoch_steps(self, bx, by, bw, theta, c_global, losses,
                     correct_total) -> float:
        """SGD steps over a [S, B, ...] stack (the training body of both
        local updates): appends the per-batch losses, adds the weighted
        correct count and the weight into ``correct_total`` and returns
        the mean batch loss."""
        theta_t = ({k: v.detach().clone() for k, v in theta.items()}
                   if theta is not None else None)
        x, y, w = self._stack(bx), self._stack(by, torch.long), self._stack(bw)
        step_loss, step_correct, step_weight = [], [], []
        for s in range(x.shape[0]):
            self.optimizer.zero_grad()
            out = self.model(x[s])
            per = F.cross_entropy(out, y[s], reduction="none")
            loss = (per * w[s]).sum() / w[s].sum().clamp(min=1.0)
            if self.l2:
                loss = loss + 0.5 * self.l2 * sum(
                    (p ** 2).sum() for p in self.model.parameters())
            loss.backward()
            if self.algorithm in ("fedprox", "fedadmm"):
                for n, p in self.model.named_parameters():
                    if p.grad is None:
                        continue
                    extra = self.rho * (p.detach() - theta_t[n])
                    if self.algorithm == "fedadmm":
                        extra = extra + self.alpha[n]
                    p.grad = p.grad + extra
            elif self.algorithm == "scaffold":
                for n, p in self.model.named_parameters():
                    if p.grad is None:
                        continue
                    p.grad = p.grad - self.control[n] + c_global[n]
            self.optimizer.step()
            step_loss.append(loss.detach())
            with torch.no_grad():
                pred = out.argmax(dim=1)
                step_correct.append(((pred == y[s]).float() * w[s]).sum())
                step_weight.append(w[s].sum())
        losses.extend(_host_floats(step_loss))
        for c, n in zip(_host_floats(step_correct), _host_floats(step_weight)):
            correct_total[0] += c
            correct_total[1] += n
        return float(np.mean(losses[-x.shape[0]:]))

    def update_duals(self, theta: Mapping) -> None:
        """ADMM dual ascent after the local epochs."""
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                self.alpha[n] = self.alpha[n] + self.rho * (p - theta[n])

    def update_controls(self, theta: Mapping, c_global: Mapping,
                        lr: float, num_steps: int) -> dict:
        """SCAFFOLD option II, c_i⁺ = c_i − c + (theta − y)/(K·lr);
        returns the delta c_i⁺ − c_i the server adds into c."""
        scale = 1.0 / (lr * max(num_steps, 1))
        delta = {}
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                new = (self.control[n] - c_global[n]
                       + scale * (theta[n] - p.detach()))
                delta[n] = new - self.control[n]
                self.control[n] = new
        return delta


def _host_floats(ts: list[torch.Tensor]) -> list[float]:
    """Scalar tensors → Python floats, in one device→host copy (each
    value is the f32 one ``float(t)`` would give)."""
    if not ts:
        return []
    return torch.stack(ts).cpu().tolist()


def _running_sum(xs: list[float]) -> float:
    """Left-to-right float sum (the reference's ``+=`` accumulation)."""
    acc = 0.0
    for v in xs:
        acc += v
    return acc


def consensus(neighbor_states: list[tuple[float, Mapping]]) -> dict:
    """w ← Σ_j a_j · state_j (the reference's ``Client.consensus``): a
    plain weighted sum with no implicit self term."""
    out: dict = {}
    for a, st in neighbor_states:
        for k, v in st.items():
            acc = out.get(k)
            out[k] = a * v if acc is None else acc + a * v
    return out
