"""Associative-Rendezvous profiles (paper §IV-D1): the lane encoding.

Port of ``repro.core.profiles``: a copy of its numpy encoding (slot
layout, ``VK_*``/``L_*`` constants, ``ProfileBuilder``, ``profile``,
``ARMessage`` and the action codes), with :func:`batch_profiles`
returning a torch tensor.

A profile is a set of keyword slots.  Each slot constrains an *attribute*
(a keyword, exact or prefix) and optionally a *value* (exact keyword,
partial keyword/prefix, wildcard, or numeric range) — the paper's
``addSingle("Drone")``, ``addSingle("Li*")``, ``(lat, 40..50)`` forms.

Encoding: every slot is SLOT_WIDTH int32 lanes; a profile is
MAX_SLOTS x SLOT_WIDTH = 128 int32 lanes (512 B), so a batch of
profiles is one contiguous ``[N, 128]`` int32 tensor.

Keywords are packed big-endian into two int32 words (8 ASCII bytes,
truncated).  Prefix predicates pre-compute their byte masks at *encode*
time, so the device-side match is pure xor/and/compare — no variable
shifts on the hot path (the paper's "memory-mapped" discipline: lay
data out so the hot path is sequential masked compares).

Slot int32 layout (lane offsets within the slot):
  0 attr_a   1 attr_b     packed attribute keyword
  2 amask_a  3 amask_b    attribute compare masks (all-ones = exact)
  4 vkind                 0 NONE 1 EXACT 2 PREFIX 3 ANY 4 RANGE 5 NUM
  5 v_a      6 v_b        packed value keyword / numeric value / range lo-hi
  7 vmask_a  8 vmask_b    value compare masks (PREFIX)
  9 used                  1 if the slot is populated
  10..15 reserved (zero)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device

SLOT_WIDTH = 16
MAX_SLOTS = 8
PROFILE_WIDTH = SLOT_WIDTH * MAX_SLOTS  # 128 int32 lanes

# vkind codes
VK_NONE, VK_EXACT, VK_PREFIX, VK_ANY, VK_RANGE, VK_NUM = 0, 1, 2, 3, 4, 5

# lane offsets
L_ATTR_A, L_ATTR_B, L_AMASK_A, L_AMASK_B = 0, 1, 2, 3
L_VKIND, L_V_A, L_V_B, L_VMASK_A, L_VMASK_B, L_USED = 4, 5, 6, 7, 8, 9

_U32 = np.uint32


def pack_keyword(word: str) -> tuple[int, int]:
    """Pack up to 8 ASCII bytes big-endian into two int32 words."""
    raw = word.encode("ascii", "replace")[:8].ljust(8, b"\x00")
    a = int.from_bytes(raw[:4], "big")
    b = int.from_bytes(raw[4:], "big")
    # store as signed int32 bit patterns
    return (np.int32(_U32(a)).item(), np.int32(_U32(b)).item())


def prefix_masks(plen: int) -> tuple[int, int]:
    """Byte masks covering the first ``plen`` bytes of a packed keyword."""
    if not 0 <= plen <= 8:
        raise ValueError(f"prefix length must be in [0,8], got {plen}")
    ka, kb = min(plen, 4), max(plen - 4, 0)
    ma = _U32(0xFFFFFFFF) << _U32(32 - 8 * ka) if ka else _U32(0)
    mb = _U32(0xFFFFFFFF) << _U32(32 - 8 * kb) if kb else _U32(0)
    return (np.int32(ma).item(), np.int32(mb).item())


FULL_MASK = prefix_masks(8)


def _is_prefix(word: str) -> bool:
    return word.endswith("*") and len(word) > 1


@dataclasses.dataclass(frozen=True)
class Slot:
    attr: str                      # keyword, may end with '*' for prefix
    vkind: int = VK_NONE
    value: str | int | None = None
    hi: int | None = None          # range upper bound

    def encode(self) -> np.ndarray:
        lane = np.zeros(SLOT_WIDTH, dtype=np.int32)
        attr = self.attr
        if attr == "*":
            lane[L_AMASK_A], lane[L_AMASK_B] = 0, 0  # matches anything
        elif _is_prefix(attr):
            lane[L_ATTR_A], lane[L_ATTR_B] = pack_keyword(attr[:-1])
            # keywords pack to 8 bytes; longer prefixes clamp to full-width
            lane[L_AMASK_A], lane[L_AMASK_B] = prefix_masks(min(len(attr) - 1, 8))
        else:
            lane[L_ATTR_A], lane[L_ATTR_B] = pack_keyword(attr)
            lane[L_AMASK_A], lane[L_AMASK_B] = FULL_MASK
        lane[L_VKIND] = self.vkind
        if self.vkind == VK_EXACT:
            lane[L_V_A], lane[L_V_B] = pack_keyword(str(self.value))
        elif self.vkind == VK_PREFIX:
            v = str(self.value)
            lane[L_V_A], lane[L_V_B] = pack_keyword(v)
            lane[L_VMASK_A], lane[L_VMASK_B] = prefix_masks(min(len(v), 8))
        elif self.vkind == VK_RANGE:
            lane[L_V_A], lane[L_V_B] = int(self.value), int(self.hi)
        elif self.vkind == VK_NUM:
            lane[L_V_A] = int(self.value)
        lane[L_USED] = 1
        return lane


class ProfileBuilder:
    """Mirrors the paper's ``ARMessage.Profile.newBuilder()`` API."""

    def __init__(self) -> None:
        self._slots: list[Slot] = []

    def add_single(self, keyword: str) -> "ProfileBuilder":
        """Singleton attribute; '*'-suffixed keywords are prefixes (``Li*``)."""
        self._slots.append(Slot(attr=keyword))
        return self

    def add_pair(self, attr: str, value: str) -> "ProfileBuilder":
        if _is_prefix(value):
            self._slots.append(Slot(attr, VK_PREFIX, value[:-1]))
        else:
            self._slots.append(Slot(attr, VK_EXACT, value))
        return self

    def add_num(self, attr: str, value: int) -> "ProfileBuilder":
        self._slots.append(Slot(attr, VK_NUM, int(value)))
        return self

    def add_range(self, attr: str, lo: int, hi: int) -> "ProfileBuilder":
        self._slots.append(Slot(attr, VK_RANGE, int(lo), hi=int(hi)))
        return self

    def add_any(self, attr: str) -> "ProfileBuilder":
        self._slots.append(Slot(attr, VK_ANY))
        return self

    def build(self) -> np.ndarray:
        if len(self._slots) > MAX_SLOTS:
            raise ValueError(f"profile has {len(self._slots)} slots > {MAX_SLOTS}")
        out = np.zeros((MAX_SLOTS, SLOT_WIDTH), dtype=np.int32)
        for i, s in enumerate(self._slots):
            out[i] = s.encode()
        return out.reshape(PROFILE_WIDTH)


def profile(*singles: str, **pairs) -> np.ndarray:
    """Shorthand: ``profile("Drone", "Li*", lat=40)``."""
    b = ProfileBuilder()
    for s in singles:
        b.add_single(s)
    for k, v in pairs.items():
        if isinstance(v, int):
            b.add_num(k, v)
        elif isinstance(v, tuple):
            b.add_range(k, v[0], v[1])
        else:
            b.add_pair(k, v)
    return b.build()


def batch_profiles(profiles: Sequence[np.ndarray],
                   device: str | torch.device | None = None) -> torch.Tensor:
    """Stack encoded profiles into a [N, PROFILE_WIDTH] int32 tensor on
    ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)
    if not len(profiles):
        return torch.zeros((0, PROFILE_WIDTH), dtype=torch.int32,
                           device=device)
    return torch.from_numpy(np.stack(
        [np.asarray(p, dtype=np.int32) for p in profiles])).to(device)


# ---------------------------------------------------------------------------
# AR message (paper quintuplet: header/profile, action, data, location, topology)
# ---------------------------------------------------------------------------

# action codes (paper §IV-D1)
A_STORE, A_STATISTICS, A_STORE_FUNCTION, A_START_FUNCTION = 0, 1, 2, 3
A_STOP_FUNCTION, A_NOTIFY_INTEREST, A_NOTIFY_DATA, A_DELETE = 4, 5, 6, 7

ACTION_NAMES = [
    "store", "statistics", "store_function", "start_function",
    "stop_function", "notify_interest", "notify_data", "delete",
]


@dataclasses.dataclass(frozen=True)
class ARMessage:
    """The AR quintuplet.  ``data`` is an arbitrary payload."""
    profile: np.ndarray           # [PROFILE_WIDTH] int32
    action: int
    data: object = None
    location: tuple[float, float] | None = None   # (lat, lon)
    topology: str | None = None

    def __post_init__(self):
        if np.asarray(self.profile).shape != (PROFILE_WIDTH,):
            raise ValueError("profile must be a flat encoded profile")
