"""Public wrappers of the ``hdrf_score`` kernel: dispatch on the device.

Two entries: ``hdrf_choose`` takes (E, k) replica flags, as the
reference's ``hdrf_choose`` does; ``hdrf_choose_bits`` takes the packed
replica bit matrix, the degree table and the endpoints, and is what the
chunk functions call.  A CUDA tensor goes to the hand-written kernel,
which launches or raises; a CPU tensor goes to the plain torch version in
``ref.py``.  Nothing falls back from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from .. import EntryCounter
from ...core.bitops import num_words
from . import kernel
from .ref import hdrf_choose_bits_ref, hdrf_choose_ref

launches = EntryCounter()

_FLAG_DTYPES = (torch.bool, torch.int8, torch.uint8)
_INDEX_DTYPES = (torch.int32, torch.int64)


def _check(name, t, dtypes, shape, device, fn="hdrf_choose"):
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


def hdrf_choose(du, dv, rep_u, rep_v, sizes, hrep_u=None, hrep_v=None, *,
                lam: float, dcn_penalty: float = 0.0,
                degree_weighted: bool = True):
    """(E,) int32 degrees ``du``/``dv``, (E, k) replica flags ``rep_u``/
    ``rep_v`` (bool or 0/1 int8), (k,) int32 partition ``sizes`` ->
    (chosen (E,) int32, best (E,) float32).

    ``chosen`` is the first index of each row's highest HDRF score (the
    reference's ``jnp.argmax``), ``best`` that score.  With ``dcn_penalty``
    != 0 the (E, k) host-group presence flags ``hrep_u``/``hrep_v``
    (``core.scoring.host_any``) subtract the host penalty;
    ``degree_weighted=False`` scores PowerGraph Greedy.
    """
    if du.device.type != "cuda":
        return hdrf_choose_ref(du, dv, rep_u, rep_v, sizes, hrep_u, hrep_v,
                               lam=lam, dcn_penalty=dcn_penalty,
                               degree_weighted=degree_weighted)
    if rep_u.dim() != 2:
        raise ValueError(f"hdrf_choose: rep_u must be (E, k), got shape "
                         f"{tuple(rep_u.shape)}")
    E, k = rep_u.shape
    dev = du.device
    for name, t in (("du", du), ("dv", dv)):
        _check(name, t, (torch.int32,), (E,), dev)
    _check("sizes", sizes, (torch.int32,), (k,), dev)
    flags = [("rep_u", rep_u), ("rep_v", rep_v)]
    if dcn_penalty:
        if hrep_u is None or hrep_v is None:
            raise ValueError("hdrf_choose: dcn_penalty != 0 needs hrep_u "
                             "and hrep_v")
        flags += [("hrep_u", hrep_u), ("hrep_v", hrep_v)]
    else:
        hrep_u = hrep_v = None
    for name, t in flags:
        _check(name, t, _FLAG_DTYPES, (E, k), dev)
    chosen = torch.empty(E, dtype=torch.int32, device=dev)
    best = torch.empty(E, dtype=torch.float32, device=dev)
    if E == 0:
        return chosen, best
    kernel.launch_flags(du, dv, rep_u, rep_v, sizes, hrep_u, hrep_v,
                        lam=lam, dcn_penalty=float(dcn_penalty),
                        degree_weighted=degree_weighted, chosen=chosen,
                        best=best)
    launches.add("flags")
    return chosen, best


def hdrf_choose_bits(bits, d, uv, sizes, *, k: int, lam: float,
                     num_hosts: int = 0, dcn_penalty: float = 0.0,
                     degree_weighted: bool = True):
    """The same choice for E edges read from the replication state itself:
    the int32 packed bit matrix ``bits`` (V, ceil(k/32)), the int32 degree
    table ``d`` (V,), the endpoints ``uv`` = [u..., v...] (2E,) int32 or
    int64 and the (k,) int32 ``sizes`` -> (chosen (E,) int32, best (E,)
    float32), equal to ``hdrf_choose`` on the gathered flags and degrees.

    With ``dcn_penalty`` != 0 and ``num_hosts`` > 1 the host presence is
    ``host_any`` of the same rows (``k`` a multiple of ``num_hosts``, host
    groups of ``k / num_hosts`` consecutive partitions).  The kernel reads
    each endpoint's words and degree itself, so no (2E, k) matrix is made
    on the card; endpoints follow JAX's gather rule there (wrapped once,
    clamped to [0, V)).
    """
    hosted = bool(dcn_penalty) and num_hosts > 1
    if hosted and k % num_hosts:
        raise ValueError(f"hdrf_choose_bits: k={k} is not a multiple of "
                         f"num_hosts={num_hosts}")
    if bits.device.type != "cuda":
        return hdrf_choose_bits_ref(
            bits, d, uv, sizes, k=k, lam=lam,
            num_hosts=num_hosts if hosted else 0,
            dcn_penalty=dcn_penalty if hosted else 0.0,
            degree_weighted=degree_weighted)
    fn, dev = "hdrf_choose_bits", bits.device
    if bits.dim() != 2 or uv.dim() != 1 or uv.shape[0] % 2:
        raise ValueError(f"{fn}: bits must be (V, W) and uv (2E,), got "
                         f"{tuple(bits.shape)} and {tuple(uv.shape)}")
    V = bits.shape[0]
    _check("bits", bits, (torch.int32,), (V, num_words(k)), dev, fn)
    _check("d", d, (torch.int32,), (V,), dev, fn)
    _check("uv", uv, _INDEX_DTYPES, tuple(uv.shape), dev, fn)
    _check("sizes", sizes, (torch.int32,), (k,), dev, fn)
    E = uv.shape[0] // 2
    chosen = torch.empty(E, dtype=torch.int32, device=dev)
    best = torch.empty(E, dtype=torch.float32, device=dev)
    if E == 0:
        return chosen, best
    if V == 0:
        raise ValueError(f"{fn}: endpoints into an empty bit matrix")
    kernel.launch_bits(bits, d, uv, sizes, k=k, lam=lam,
                       dcn_penalty=float(dcn_penalty) if hosted else 0.0,
                       group=k // num_hosts if hosted else k,
                       degree_weighted=degree_weighted, chosen=chosen,
                       best=best)
    launches.add("bits")
    return chosen, best
