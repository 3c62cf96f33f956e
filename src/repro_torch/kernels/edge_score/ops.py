"""Public wrappers of the ``edge_score`` kernel: dispatch on the device.

Two entries: ``edge_score_choose_bits`` reads the replication state and the
cluster tables itself and makes a 2PS-L scoring chunk's whole choice (what
the chunk functions call); ``edge_score_choose`` takes the ten gathered
(E,) operands, as the reference's ``edge_score_choose`` does.  A CUDA
tensor goes to the hand-written kernel, which launches or raises; a CPU
tensor goes to the plain torch version in ``ref.py``.  Nothing falls back
from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from .. import EntryCounter
from . import kernel
from .ref import edge_score_choose_bits_ref, edge_score_choose_ref

launches = EntryCounter()

_INT_ARGS = ("du", "dv", "vol_u", "vol_v", "pu", "pv")
_FLAG_DTYPES = (torch.bool, torch.int8, torch.uint8)
_INDEX_DTYPES = (torch.int32, torch.int64)
_I32 = (torch.int32,)


def _check(name, t, dtypes, shape, device, fn="edge_score_choose"):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{fn}: {name} has dtype {t.dtype}, expected "
                        f"one of {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")


def edge_score_choose(du, dv, vol_u, vol_v, rep_u1, rep_v1, rep_u2, rep_v2,
                      pu, pv, hrep_u1=None, hrep_v1=None, hrep_u2=None,
                      hrep_v2=None, *, dcn_penalty: float = 0.0):
    """Flat (E,) inputs -> (chosen (E,) int32, best (E,) float32).

    Same arguments and outputs as the reference's
    ``repro.kernels.edge_score.edge_score_choose``: degrees ``du``/``dv``
    and cluster volumes ``vol_u``/``vol_v`` (int32), the four replica flags
    of each endpoint on each candidate (bool or 0/1 int8), the candidates
    ``pu``/``pv`` (int32), and with ``dcn_penalty`` != 0 the four
    host-group presence flags.  ``chosen = pv if s2 > s1 else pu``,
    ``best = max(s1, s2)``.
    """
    flags = (rep_u1, rep_v1, rep_u2, rep_v2)
    hflags = (hrep_u1, hrep_v1, hrep_u2, hrep_v2) if dcn_penalty else None
    if du.device.type != "cuda":
        return edge_score_choose_ref(du, dv, vol_u, vol_v, *flags, pu, pv,
                                     *(hflags or ()),
                                     dcn_penalty=dcn_penalty)
    E, dev = du.shape[0], du.device
    ints = (du, dv, vol_u, vol_v, pu, pv)
    for name, t in zip(_INT_ARGS, ints):
        _check(name, t, _I32, (E,), dev)
    for i, t in enumerate(flags):
        _check(f"rep flag {i}", t, _FLAG_DTYPES, (E,), dev)
    if hflags is not None:
        if any(h is None for h in hflags):
            raise ValueError("edge_score_choose: dcn_penalty != 0 needs all "
                             "four hrep_* flags")
        for i, t in enumerate(hflags):
            _check(f"host flag {i}", t, _FLAG_DTYPES, (E,), dev)
    chosen = torch.empty(E, dtype=torch.int32, device=dev)
    best = torch.empty(E, dtype=torch.float32, device=dev)
    if E == 0:
        return chosen, best
    kernel.launch(ints, flags, hflags, float(dcn_penalty), chosen, best)
    launches.add("flags")
    return chosen, best


def edge_score_choose_bits(bits, d, vol, v2c, c2p, edges, valid, *,
                           hbits=None, host_of=None,
                           dcn_penalty: float = 0.0):
    """2PS-L's two-candidate choice for a chunk of E edges, read from the
    replication state and the cluster tables themselves: the int32 packed
    bit matrix ``bits`` (V, ceil(k/32)), the int32 degree table ``d`` and
    cluster map ``v2c`` (V,), the int32 cluster volumes ``vol`` and
    partitions ``c2p`` (clusters,), the endpoints ``edges`` (E, 2) int32 or
    int64 and the bool mask ``valid`` (E,); with ``dcn_penalty`` != 0 also
    the per-host bit matrix ``hbits`` (V, ceil(H/32)) and ``host_of`` (k,)
    int32.

    Returns ``(chosen (E,) int32, best (E,) float32, todo (E,) bool,
    hi (E,) of edges' dtype)``, equal to ``edge_score_choose`` on the
    gathered operands (``edge_score_choose_bits_ref``).  On the card the
    kernel reads every table itself, one launch, so no per-edge operand
    reaches device memory; endpoints follow JAX's gather rule in the reads
    (wrapped once, clamped to [0, V)).
    """
    hosted = bool(dcn_penalty)
    if hosted and (hbits is None or host_of is None):
        raise ValueError("edge_score_choose_bits: dcn_penalty != 0 needs "
                         "hbits and host_of")
    if bits.device.type != "cuda":
        return edge_score_choose_bits_ref(bits, d, vol, v2c, c2p, edges,
                                          valid, hbits=hbits,
                                          host_of=host_of,
                                          dcn_penalty=dcn_penalty)
    fn, dev = "edge_score_choose_bits", bits.device
    if bits.dim() != 2 or edges.dim() != 2 or vol.dim() != 1:
        raise ValueError(f"{fn}: bits must be (V, W), edges (E, 2) and vol "
                         f"(clusters,), got {tuple(bits.shape)}, "
                         f"{tuple(edges.shape)} and {tuple(vol.shape)}")
    V, W = bits.shape
    E = edges.shape[0]
    _check("bits", bits, _I32, (V, W), dev, fn)
    for name, t in (("d", d), ("v2c", v2c)):
        _check(name, t, _I32, (V,), dev, fn)
    for name, t in (("vol", vol), ("c2p", c2p)):
        _check(name, t, _I32, tuple(vol.shape), dev, fn)
    _check("edges", edges, _INDEX_DTYPES, (E, 2), dev, fn)
    _check("valid", valid, (torch.bool,), (E,), dev, fn)
    if hosted:
        if hbits.dim() != 2 or host_of.dim() != 1:
            raise ValueError(f"{fn}: hbits must be (V, HW) and host_of "
                             f"(k,), got {tuple(hbits.shape)} and "
                             f"{tuple(host_of.shape)}")
        k = host_of.shape[0]
        _check("host_of", host_of, _I32, (k,), dev, fn)
        _check("hbits", hbits, _I32, (V, hbits.shape[1]), dev, fn)
        if W != -(-k // 32):
            raise ValueError(f"{fn}: bits has {W} words a row, host_of "
                             f"{k} partitions")
    chosen = torch.empty(E, dtype=torch.int32, device=dev)
    best = torch.empty(E, dtype=torch.float32, device=dev)
    todo = torch.empty(E, dtype=torch.bool, device=dev)
    hi = torch.empty(E, dtype=edges.dtype, device=dev)
    if E == 0:
        return chosen, best, todo, hi
    if V == 0 or W == 0:
        raise ValueError(f"{fn}: endpoints into an empty bit matrix")
    kernel.launch_bits(bits, d, vol, v2c, c2p, edges, valid,
                       hbits if hosted else None,
                       host_of if hosted else None,
                       dcn_penalty=float(dcn_penalty), chosen=chosen,
                       best=best, todo=todo, hi=hi)
    launches.add("bits")
    return chosen, best, todo, hi
