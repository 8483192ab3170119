"""Associative selection (paper §IV-D1): content-based profile matching.

Port of ``repro.core.matching``.  An *interest* profile p matches a
*data* profile d iff every used slot of p is satisfied by some slot of
d:
  - attribute: exact or prefix (pre-computed byte masks) or wildcard;
  - value: NONE (presence only), EXACT, PREFIX, ANY, RANGE (numeric).

:func:`slot_match` is plain torch.  :func:`match_matrix`, and every
form of :func:`profile_match` that is an outer product of interests
and data profiles (one interest against a table, a table against one
profile, ``[1, N]`` against ``[M, 1]``, one against one), go through
``kernels.armatch.armatch``: the ``armatch`` kernel on a CUDA tensor,
the plain :func:`_match_matrix_plain` on a CPU tensor.  Only the
elementwise forms (interests and data paired row by row) broadcast in
plain torch on either device.

:func:`_match_matrix_plain` walks the data in row chunks, so that no
``[M, N, 8, 8]`` intermediate of the reference's broadcast grows past
about 256 MB; the result is the same.
"""
from __future__ import annotations

import torch

from repro_torch.core import profiles as P

#: elements of one ``[chunk, N, 8, 8]`` int32 intermediate (256 MB)
_CHUNK_ELEMS = 1 << 26


def _slots(prof: torch.Tensor) -> torch.Tensor:
    prof = torch.as_tensor(prof).to(torch.int32)
    return prof.reshape(prof.shape[:-1] + (P.MAX_SLOTS, P.SLOT_WIDTH))


def slot_match(ps: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """Elementwise slot predicate.  ps, ds: [..., SLOT_WIDTH] broadcastable."""
    ps = torch.as_tensor(ps).to(torch.int32)
    ds = torch.as_tensor(ds).to(torch.int32)
    used = (ps[..., P.L_USED] > 0) & (ds[..., P.L_USED] > 0)
    # attribute: masked xor compare (mask==0 => wildcard attr)
    am_a = (ps[..., P.L_ATTR_A] ^ ds[..., P.L_ATTR_A]) & ps[..., P.L_AMASK_A]
    am_b = (ps[..., P.L_ATTR_B] ^ ds[..., P.L_ATTR_B]) & ps[..., P.L_AMASK_B]
    attr_ok = (am_a == 0) & (am_b == 0)
    pk = ps[..., P.L_VKIND]
    dk = ds[..., P.L_VKIND]
    p_va, p_vb = ps[..., P.L_V_A], ps[..., P.L_V_B]
    d_va, d_vb = ds[..., P.L_V_A], ds[..., P.L_V_B]
    v_eq = (p_va == d_va) & (p_vb == d_vb)
    pm_a = (p_va ^ d_va) & ps[..., P.L_VMASK_A]
    pm_b = (p_vb ^ d_vb) & ps[..., P.L_VMASK_B]
    in_range = (p_va <= d_va) & (d_va <= p_vb)          # signed int32
    # the reference's nested where over pk, as a sum of disjoint cases
    # (any other pk, VK_NUM included, is False)
    val_ok = ((pk == P.VK_NONE)
              | ((pk == P.VK_EXACT) & (dk == P.VK_EXACT) & v_eq)
              | ((pk == P.VK_PREFIX) & (dk == P.VK_EXACT)
                 & (pm_a == 0) & (pm_b == 0))
              | ((pk == P.VK_ANY) & (dk != P.VK_NONE))
              | ((pk == P.VK_RANGE) & (dk == P.VK_NUM) & in_range))
    return used & attr_ok & val_ok


def _profile_match(interest: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The reference's broadcast: [..., 128] x [..., 128] -> [...] bool."""
    ps = _slots(interest)[..., :, None, :]   # [..., Sp, 1, W]
    ds = _slots(data)[..., None, :, :]       # [..., 1, Sd, W]
    m = slot_match(ps, ds)                   # [..., Sp, Sd]
    p_used = _slots(interest)[..., :, P.L_USED] > 0
    sat = m.any(-1)                          # [..., Sp]
    return (sat | ~p_used).all(-1) & p_used.any(-1)


def _armatch(data: torch.Tensor, interests: torch.Tensor) -> torch.Tensor:
    """[M, 128] x [N, 128] -> [M, N] bool through the kernel's wrapper."""
    # imported here: kernels.armatch.ref imports this module
    from repro_torch.kernels.armatch import armatch
    return armatch(data.to(torch.int32).reshape(-1, P.PROFILE_WIDTH),
                   interests.to(torch.int32).reshape(-1, P.PROFILE_WIDTH)
                   ).to(torch.bool)


def profile_match(interest: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Interest vs data profiles -> bool (broadcasts).

    Where every broadcast dim is 1 on one side, the result is an outer
    product of interest rows and data rows: it is one ``armatch`` call
    (the kernel on a CUDA tensor), reshaped.  Otherwise the reference's
    broadcast, in plain torch."""
    interest, data = torch.as_tensor(interest), torch.as_tensor(data)
    r = max(interest.dim(), data.dim()) - 1
    ib = (1,) * (r - interest.dim() + 1) + tuple(interest.shape[:-1])
    db = (1,) * (r - data.dim() + 1) + tuple(data.shape[:-1])
    if not all(i == 1 or d == 1 for i, d in zip(ib, db)):
        return _profile_match(interest, data)
    out = _armatch(data, interest).reshape(db + ib)
    # dims j and r + j hold one size each (the other is 1): interleave
    # them, so that each adjacent pair merges into the broadcast dim
    order = [k for j in range(r) for k in (j, r + j)]
    return out.permute(order).reshape(tuple(max(i, d)
                                            for i, d in zip(ib, db)))


def match_matrix(data: torch.Tensor, interests: torch.Tensor) -> torch.Tensor:
    """[M, PROFILE_WIDTH] data x [N, PROFILE_WIDTH] interests -> [M, N]
    bool, through ``armatch``: the kernel on a CUDA tensor."""
    data, interests = torch.as_tensor(data), torch.as_tensor(interests)
    return _armatch(data, interests)


def _match_matrix_plain(data: torch.Tensor,
                        interests: torch.Tensor) -> torch.Tensor:
    """:func:`match_matrix` in plain torch on either device, in row
    chunks of ``data``: the ``armatch`` kernel's plain version."""
    data, interests = torch.as_tensor(data), torch.as_tensor(interests)
    m, n = data.shape[0], interests.shape[0]
    per_row = max(n, 1) * P.MAX_SLOTS * P.MAX_SLOTS
    chunk = max(1, _CHUNK_ELEMS // per_row)
    if m <= chunk:
        return _profile_match(interests[None, :, :], data[:, None, :])
    out = torch.empty((m, n), dtype=torch.bool, device=data.device)
    for r in range(0, m, chunk):
        out[r:r + chunk] = _profile_match(interests[None, :, :],
                                          data[r:r + chunk, None, :])
    return out
