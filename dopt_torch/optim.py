"""Local optimizer: momentum SGD with torch semantics.

The reference trains every client with ``torch.optim.SGD(lr, momentum)``:

    buf ← momentum·buf + grad        (buf starts at grad on first step)
    p   ← p − lr·buf

(no dampening, no Nesterov).  Zero-initialised buffers are exactly
equivalent to torch's lazy buf-starts-at-grad initialisation.  This is
the port of ``dopt.optim.sgd_step``, updating the tensors in place.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def sgd_step(params, moms, grads, *, lr: float, momentum: float) -> None:
    """One momentum-SGD step over lists of tensors, in place.  Each op
    is rounded on its own, in f32, and the results are cast back to the
    storage dtype — the same arithmetic as the fused CUDA kernel, whose
    plain version this is (``dopt_torch.ops.sgd_momentum_reference``)."""
    for p, m, g in zip(params, moms, grads):
        buf = m.float() * momentum + g.float()
        p.copy_(p.float() - lr * buf)
        m.copy_(buf)
