"""Plain torch version of the ``augru`` kernel: the CPU path of ``augru``
and the yardstick the CUDA kernel is held to on the card.  A Python loop
over T in float32, the reference's ``lax.scan`` step for step;
``augru_backward_ref`` its gradient, formed explicitly in reverse time."""
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


def augru_backward_ref(x_gates, u, att, h0, out, dout):
    """The gradients of ``augru_ref(x_gates, u, att, h0)`` for the output
    gradient ``dout`` (B, T, H), given its output ``out``: (dx_gates
    (B, T, 3H), du (H, 3H), datt (B, T), dh0 (B, H)), float32, formed as
    the backward kernel forms them: a reverse-time loop that recomputes
    hU, r, z and n from the saved states, then ``du`` as one product of
    the previous states and ``dhU`` over all (B, T) rows."""
    B, T, H = out.shape
    xg, a, u = x_gates.float(), att.float(), u.float()
    h_all = torch.cat([h0.float()[:, None], out.float()[:, :-1]], dim=1)
    dxg = torch.empty((B, T, 3 * H), dtype=torch.float32, device=out.device)
    dhu = torch.empty_like(dxg)
    datt = torch.empty((B, T), dtype=torch.float32, device=out.device)
    dh = torch.zeros((B, H), dtype=torch.float32, device=out.device)
    for t in reversed(range(T)):
        h = h_all[:, t]
        hU = h @ u
        x = xg[:, t]
        r = torch.sigmoid(x[:, :H] + hU[:, :H])
        z = torch.sigmoid(x[:, H:2 * H] + hU[:, H:2 * H])
        n = torch.tanh(x[:, 2 * H:] + r * hU[:, 2 * H:])
        at = a[:, t, None]
        zg = at * z
        dh = dh + dout[:, t].float()
        dzg = dh * (n - h)
        dxn = dh * zg * (1.0 - n * n)
        dxz = dzg * at * z * (1.0 - z)
        dxr = dxn * hU[:, 2 * H:] * r * (1.0 - r)
        datt[:, t] = (dzg * z).sum(dim=-1)
        dxg[:, t] = torch.cat([dxr, dxz, dxn], dim=-1)
        dhu[:, t] = torch.cat([dxr, dxz, dxn * r], dim=-1)
        dh = dh * (1.0 - zg) + dhu[:, t] @ u.T
    du = h_all.reshape(B * T, H).T @ dhu.reshape(B * T, 3 * H)
    return dxg, du, datt, dh
