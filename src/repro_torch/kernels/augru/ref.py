"""Plain torch version of the ``augru`` kernel: the CPU path of ``augru``
and the yardstick the CUDA kernel is held to on the card.  A Python loop
over T in float32, the reference's ``lax.scan`` step for step."""
from __future__ import annotations

import torch


def augru_ref(x_gates, u, att, h0):
    """x_gates: (B, T, 3H); u: (H, 3H); att: (B, T); h0: (B, H).
    Gate layout (r, z, n).  Returns (B, T, H) hidden states."""
    H = h0.shape[-1]
    xg = x_gates.float()
    a = att.float()
    u = u.float()
    h = h0.float()
    states = []
    for t in range(x_gates.shape[1]):
        x = xg[:, t]
        hU = h @ u
        r = torch.sigmoid(x[:, :H] + hU[:, :H])
        z = torch.sigmoid(x[:, H:2 * H] + hU[:, H:2 * H])
        n = torch.tanh(x[:, 2 * H:] + r * hU[:, 2 * H:])
        zg = a[:, t, None] * z
        h = (1.0 - zg) * h + zg * n
        states.append(h)
    if not states:
        return xg.new_empty((x_gates.shape[0], 0, H)).to(x_gates.dtype)
    return torch.stack(states, dim=1).to(x_gates.dtype)
