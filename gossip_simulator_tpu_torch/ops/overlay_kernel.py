"""The phase-1 overlay kernels: the port's counterparts of the JAX
package's ``ops/pallas_overlay_kernel.py``.

* ``fused_negotiate`` -- one mailbox slot of membership decisions for
  every row at once: the makeup accept-under-fanin / evict-at-a-drawn-
  position decision, or the breakup first-match remove-over-fanout /
  replace-with-a-drawn-peer decision, with the reply emission
  ``where(mask, value, -1)`` from the same pass; plain version
  ``negotiate_plain``, the one-hot body of the Pallas kernel over all rows.
* ``fused_request_round`` -- the rounds overlay's staggered bootstrap:
  every row under fanout appends its pre-drawn peer, emits it, and the
  emitters are counted; plain version ``request_round_plain``.
* ``fused_hosted_chunk`` -- the live-entry count (entries >= 0) of every
  row of an emission matrix, which picks the split round's delivery
  chunk widths; plain version ``hosted_chunk_plain``, one popcount per
  row.

The random draws stay with the caller (``models/overlay.py``), exactly as
the JAX package draws them.  On the card each wrapper launches its CUDA
kernel (``csrc/<name>.cu``); on the CPU it takes the plain version.  A
tensor on any other device raises.  friends and cnt are updated in place.
"""

from __future__ import annotations

import ctypes

import torch

from gossip_simulator_tpu_torch.ops import _build, deliver

NAME = "fused_negotiate"
I32 = torch.int32
KINDS = ("makeup", "breakup")
# The C entry points' parameter types (csrc/<name>.cu).
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
REQUEST = "fused_request_round"
REQUEST_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]
HOSTED = "fused_hosted_chunk"
HOSTED_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]


def negotiate_plain(friends, cnt, src, has, draw, *, kind: str, limit: int):
    """Plain version: the Pallas kernel's one-hot body on all rows (makeup
    when `kind` is "makeup", limit = fanin; breakup, limit = fanout).
    Returns (friends, cnt, reply), friends and cnt written in place."""
    n, k = friends.shape
    iok = torch.arange(k, dtype=I32, device=friends.device)[None, :]
    fr = friends
    if kind == "makeup":
        under = cnt < limit
        app = has & under
        oh_app = iok == torch.clamp_max(cnt, k - 1)[:, None]
        fr = torch.where(oh_app & app[:, None], src[:, None], fr)
        new_cnt = cnt + app.to(I32)
        ev = has & ~under
        oh_v = iok == draw[:, None]
        victim = torch.where(oh_v, fr, 0).sum(dim=1, dtype=I32)
        fr = torch.where(oh_v & ev[:, None], src[:, None], fr)
        reply = torch.where(ev, victim, -1)
    else:
        in_range = iok < cnt[:, None]
        match = (fr == src[:, None]) & in_range & has[:, None]
        found = match.any(dim=1)
        first = torch.where(match, iok, k).amin(dim=1)
        pos = torch.where(found, first, 0)  # == argmax(match) per row
        over = cnt > limit
        rm = has & found & over
        rp = has & found & ~over
        lastpos = torch.clamp_min(cnt - 1, 0)
        oh_last = iok == lastpos[:, None]
        lastval = torch.where(oh_last, fr, 0).sum(dim=1, dtype=I32)
        oh_pos = iok == pos[:, None]
        posat = torch.where(oh_pos, fr, 0).sum(dim=1, dtype=I32)
        posval = torch.where(rm, lastval, torch.where(rp, draw, posat))
        # The XLA form's unmasked write: an identity on inert rows.
        fr = torch.where(oh_pos, posval[:, None], fr)
        fr = torch.where(oh_last & rm[:, None], -1, fr)
        new_cnt = cnt - rm.to(I32)
        reply = torch.where(rp, draw, -1)
    friends.copy_(fr)
    cnt.copy_(new_cnt)
    return friends, cnt, reply.to(I32)


def _launch(friends, cnt, src, has, draw, kind, limit):
    n, k = friends.shape
    dev = friends.device
    for t, nm, dt, shape in ((friends, "friends", I32, (n, k)),
                             (cnt, "cnt", I32, (n,)), (src, "src", I32, (n,)),
                             (has, "has", torch.bool, (n,)),
                             (draw, "draw", I32, (n,))):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{NAME}: {nm} must be {dt} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {nm} must be contiguous")
    fn = _build.function(NAME, "gossip_fused_negotiate", ARGTYPES)
    reply = torch.empty(n, dtype=I32, device=dev)
    stream = deliver._stream(dev.index)
    _build.count_launch(NAME)
    rc = fn(friends.data_ptr(), cnt.data_ptr(), src.data_ptr(),
            has.data_ptr(), draw.data_ptr(), reply.data_ptr(), n, k,
            int(limit), KINDS.index(kind), stream)
    _build.check(rc, NAME)
    return friends, cnt, reply


def fused_negotiate(friends, cnt, src, has, draw, *, kind: str, limit: int):
    """One mailbox slot's decisions for all rows, friends and cnt updated
    in place.  `draw` is the slot's pre-drawn randomness (makeup: the
    eviction position drawn with the pre-append counts; breakup: the
    replacement peer), `limit` fanin (makeup) or fanout (breakup).
    Returns (friends, cnt, reply) with reply = the message target where
    one must be sent, -1 elsewhere."""
    if kind not in KINDS:
        raise ValueError(f"{NAME}: kind must be one of {KINDS}, got {kind!r}")
    dev = friends.device
    if dev.type == "cpu":
        return negotiate_plain(friends, cnt, src, has, draw, kind=kind,
                               limit=limit)
    if dev.type == "cuda":
        return _launch(friends, cnt, src.contiguous(), has.contiguous(),
                       draw.contiguous(), kind, limit)
    raise ValueError(f"{NAME}: no kernel for device {dev}")


# --- fused_request_round -------------------------------------------------------


def request_round_plain(friends, cnt, w, *, fanout: int):
    """Plain version: the JAX package's XLA chain (``models/overlay.py``
    make_round_fn's bootstrap block).  Rows with cnt < fanout append w at
    column min(cnt, k - 1), count it, and emit w; every other row emits -1.
    Returns (friends, cnt, boot_em, boot_cnt int32[]), friends and cnt
    written in place."""
    k = friends.shape[1]
    under = cnt < fanout
    col = torch.arange(k, dtype=I32, device=friends.device)[None, :] \
        == torch.clamp_max(cnt, k - 1)[:, None]
    friends.copy_(torch.where(col & under[:, None], w[:, None], friends))
    cnt += under.to(I32)
    return (friends, cnt, torch.where(under, w, -1),
            under.sum(dtype=I32))


def _request_launch(friends, cnt, w, fanout):
    n, k = friends.shape
    dev = friends.device
    for t, nm, shape in ((friends, "friends", (n, k)), (cnt, "cnt", (n,)),
                         (w, "w", (n,))):
        if t.dtype != I32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{REQUEST}: {nm} must be int32 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{REQUEST}: {nm} must be contiguous")
    fn = _build.function(REQUEST, "gossip_fused_request_round",
                         REQUEST_ARGTYPES)
    em = torch.empty(n, dtype=I32, device=dev)
    total = torch.zeros((), dtype=I32, device=dev)
    stream = deliver._stream(dev.index)
    _build.count_launch(REQUEST)
    rc = fn(friends.data_ptr(), cnt.data_ptr(), w.data_ptr(), em.data_ptr(),
            total.data_ptr(), n, k, int(fanout), stream)
    _build.check(rc, REQUEST)
    return friends, cnt, em, total


def fused_request_round(friends, cnt, w, *, fanout: int):
    """The staggered bootstrap for all rows, friends and cnt updated in
    place: every row still under `fanout` appends its pre-drawn,
    self-patched needNewFriend peer `w` and emits it.  Returns (friends,
    cnt, boot_em int32[n] (w or -1), boot_cnt int32[] (the emitters))."""
    dev = friends.device
    if dev.type == "cpu":
        return request_round_plain(friends, cnt, w, fanout=fanout)
    if dev.type == "cuda":
        return _request_launch(friends, cnt, w.contiguous(), fanout)
    raise ValueError(f"{REQUEST}: no kernel for device {dev}")


# --- fused_hosted_chunk --------------------------------------------------------


def hosted_chunk_plain(mat):
    """Plain version: the JAX package's XLA side of the hosted delivery,
    one ``(row >= 0).sum()`` popcount per row.  Returns int32[r]."""
    return torch.stack([(row >= 0).sum(dtype=I32) for row in mat])


def _hosted_launch(mat):
    r, m = mat.shape
    dev = mat.device
    if mat.dtype != I32 or not mat.is_contiguous():
        raise ValueError(f"{HOSTED}: mat must be a contiguous int32 matrix, "
                         f"got {mat.dtype}, contiguous={mat.is_contiguous()}")
    if r > 65_535:
        raise ValueError(f"{HOSTED}: {r} rows exceed the kernel's grid")
    fn = _build.function(HOSTED, "gossip_fused_hosted_chunk",
                         HOSTED_ARGTYPES)
    occ = torch.zeros(r, dtype=I32, device=dev)
    stream = deliver._stream(dev.index)
    _build.count_launch(HOSTED)
    rc = fn(mat.data_ptr(), r, m, occ.data_ptr(), stream)
    _build.check(rc, HOSTED)
    return occ


def fused_hosted_chunk(mat):
    """Live entries (>= 0) of every row of an emission matrix int32[r, m]
    in one pass; returns int32[r]."""
    if mat.dim() != 2:
        raise ValueError(f"{HOSTED}: need a 2-D matrix, got shape "
                         f"{tuple(mat.shape)}")
    dev = mat.device
    if dev.type == "cpu":
        return hosted_chunk_plain(mat)
    if dev.type == "cuda":
        return _hosted_launch(mat)
    raise ValueError(f"{HOSTED}: no kernel for device {dev}")
