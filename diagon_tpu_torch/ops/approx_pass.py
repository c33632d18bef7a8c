"""Phase-1 approximate select kernels (B3, B4, B5) and their plain versions.

``approx_select``, ``approx_select_bool`` and ``approx_select_bool2`` are
the port's counterparts of ``diagon_tpu/ops/pallas/approx_pass.py``'s
``pallas_approx_select``, ``pallas_approx_select_bool`` and
``pallas_approx_select_bool2``: the same arguments in the same order, the
same results, (tile max f32 [Q, D/128], hits i32 [Q]). On CUDA tensors
they launch the hand-written kernels of ``csrc/approx_pass.cu``; on CPU
tensors they run the plain versions beside them, which are also what the
kernels are held against on the card. There is no fallback: a CUDA call
launches or raises.

They replace the Pallas kernels ``_kernel_or`` (B3,
``diagon_tpu/ops/pallas/approx_pass.py:63``), ``_kernel_bool`` (B4, :87)
and ``_kernel_bool2`` (B5, :196). All three kernels are dense products on
the tensor cores, as the TPU's are on its MXU: B3 on ``wgmma``, B4 and B5
on ``mma.sync`` from one body with the number of count products as its
parameter (csrc/approx_pass.cu says what bounds each and what its design
does about it). B4 takes four products (score; required, should and
must_not counts over presence = bank > 0), B5 two (score; the combined
count rq * 256 + sh), B3 one.

The bank is the batch-compact bf16 copy [U8, D] of the batch's clause
rows; each indicator matrix [U8, Q] (bf16) counts how often query q uses
row u in one role. Hits, the per-doc counts and so the feasibility of a
tile (-1 or not) are exact in every version: they are sums of small
integers. The tile maxima are an approximation and differ between
versions by the order of the f32 adds. The kernels sum on the tensor
cores; the plain versions add in IEEE f32. B3 rounds each tile max once to
bf16, so it and its plain version may land on neighbouring bf16 values; B4
and B5 keep the f32 max.

Why ``_APPROX_RELEPS`` = 2^-7 still bounds the error of this arithmetic
(``row_engine._APPROX_RELEPS``; the caller inflates every tile max by
``1 + _APPROX_RELEPS`` and needs it to dominate the exact f32 score of
every doc of the tile). Let a doc's clause contributions be c_t >= 0
(with multiplicity, at most T <= MAX_ROWS = 896 terms) and S their exact
real sum; u = 2^-24 is the f32 unit roundoff.

- The oracle's score is an f32 sum of the c_t: s <= S (1 + (T-1) u).
- The bank holds bf16(c_t) >= c_t (1 - 2^-9) (round to nearest even,
  8 significant bits). Each product with a small integer indicator value
  is exact in f32; at most T of them are nonzero.
- The plain versions add the nonnegative products in IEEE f32:
  p >= S (1 - 2^-9) (1 - (T-1) u), whatever the order of the adds.
- B3 (``wgmma``), B4 and B5 (``mma.sync``) add them on the tensor cores
  (bf16 in, f32 out), whose accumulator is not IEEE. Take it at its
  worst: per k-group of products (k undocumented; 8, 16 or 32), it aligns
  the group's terms and the running sum to the largest exponent among
  them, truncates each to 24 bits at that exponent, adds exactly, and
  truncates the sum to 24 bits.
  Every term is >= 0, so each truncation loses less than 2^-23 of the
  group's exact sum; a zero term loses nothing, and a group of zero
  products passes the sum through unchanged. A group with m nonzero
  products keeps more than (1 - (m + 2) 2^-23) of its exact sum (m
  products, the running sum, the result), and over the G groups that
  hold a nonzero product, G <= min(T, ceil(U8 / k)):
  p >= S (1 - 2^-9) (1 - delta), delta = (T + 2 G) 2^-23. At T = U8 = 896
  delta < 2^-12.8 for k = 8 and < 2^-11.6 even for k = 1 (G = T).
- B3 rounds its tile max once more to bf16: tmax >= p (1 - 2^-9) for the
  doc of the tile with the largest score; B4/B5 keep the f32 max.

So s / tmax <= (1 + (T-1) u) / ((1 - 2^-9)^2 (1 - delta))
(``tile_error_bound``), which for T <= 896 is below 1 + 2^-8 + 2^-11
< 1 + 2^-7 for any k (1 + 2^-7.93 at k = 8): the bound holds with a
margin of 1.8x. B5 on the tensor cores is B3 without the last bf16
rounding, so the same closed form covers it and B4's score product (the
same MMAs in the same k order) with room to spare. The f32
IEEE sums take delta = (T-1) u and give 1 + 2^-8 + 2^-12. ``tests/test_torch_approx_bound.py`` emulates the
truncating accumulator on adversarial inputs and pins this bound.

Hits stay exact on the tensor cores too: a sum of terms >= 0 that holds
one positive normal term is at least that term after any truncation, so
p > 0 iff some product is > 0, which is when the f32 score is > 0 (the
bank holds no subnormal values; ``chip_smoke.py`` checks its banks).

B5's count product cc = a_cb x (bank > 0) is exact on the tensor cores.
Every a_cb entry is rq * 256 or sh (the row engine builds a_cb only where
no (row, query) pair is both required and should, and rq < 256), presence
is 0 or 1, so every product is an integer, and with at most 64 clauses a
query cc <= 64 * 256 + 64 < 2^15. Under the worst-case accumulator above a
group's terms align to their largest exponent E <= 14 and keep 24 bits,
that is, multiples of 2^(E - 23) <= 2^-9: an integer below 2^24 loses
nothing, the exact sum of the group is again an integer below 2^24 and
truncates to itself. So cc, its decode rc = floor(cc / 256), oc = cc - 256
rc, the feasibility of every tile and the hits are exact; the bf16
indicator holds rq * 256 and sh exactly (8 significant bits cover 1..255
and 256 times them). ``tests/test_torch_approx_bound.py`` pins this on
adversarial a_cb columns.

B4's counts rc, oc, nc are three separate products, a_rq, a_sh and a_ng x
(bank > 0), by the same argument: every entry is a count of clauses, an
integer the bf16 indicator holds exactly below 256, so every product and
every sum is an integer below 2^24 and the truncating accumulator keeps it.
B4 does not pack them: it exists for the batches B5 cannot take, where a
(row, query) pair serves two roles, and there a packed entry such as
rq * 256 + sh = 257 needs 9 significant bits, which bf16 does not have.
The match test rc == nreq, oc >= msm, nc == 0, rc + oc > 0 is taken on the
exact counts as rc == nreq, oc >= lo, nc == 0 with lo = ceil(msm), at least
1 where nreq is 0 (csrc/approx_pass.cu match_counts; a numpy twin in
``tests/test_torch_approx_pass.py``); ``tests/test_torch_approx_bound.py``
pins the three counts on adversarial columns with rows in two roles.
"""

from __future__ import annotations

import torch

from diagon_tpu_torch.ops import _build, launch_counter

_LAUNCHES_B3 = launch_counter("approx_select")
_LAUNCHES_B4 = launch_counter("approx_select_bool")
_LAUNCHES_B5 = launch_counter("approx_select_bool2")

LANE = 128  # docs per tile
MAX_ROWS = 896  # the kernels stage a [U8, 128] bf16 tile in shared memory
MMA_CHUNK_Q = 64  # B3: queries per warpgroup chunk (the wgmma M)
MMA_FRAG_Q = 16  # queries per m16 A fragment; B5's mma.sync M
MMA_K = 16  # rows per MMA k-step; U8 pads to a multiple with zero rows
# [Q, chunk] f32 temporaries of the plain versions stay under this many
# elements (the card holds them next to the banks at 1M docs)
_PLAIN_CHUNK_ELEMS = 1 << 26


def tile_error_bound(T: int = MAX_ROWS, U8: int = MAX_ROWS, k: int = 8,
                     mma: bool = True) -> float:
    """The module docstring's closed form: the largest s / tmax - 1 for a
    doc of T clause terms, with the tensor cores' truncating k-group
    accumulator (``mma``) or IEEE f32 adds."""
    u = 2.0 ** -24
    if mma:
        delta = (T + 2 * min(T, -(-U8 // k))) * 2.0 ** -23
    else:
        delta = (T - 1) * u
    return (1 + (T - 1) * u) / ((1 - 2.0 ** -9) ** 2 * (1 - delta)) - 1


_BF16, _F32 = torch.bfloat16, torch.float32


def _check(mats: dict, bank, live, params=None):
    """(U8, Q, D) of arguments the kernels take, checked in one pass (the
    wrapper's host time is part of every call); ``_diagnose`` raises the
    error that names anything else."""
    dev = bank.device
    a0 = next(iter(mats.values()))
    if (
        bank.dtype == _BF16 and live.dtype == _F32 and bank.dim() == 2
        and live.dim() == 1 and a0.dim() == 2 and bank.is_contiguous()
        and live.is_contiguous() and dev.type in ("cpu", "cuda")
        and live.device == dev
        and all(m.dtype == _BF16 and m.shape == a0.shape and m.device == dev
                and m.is_contiguous() for m in mats.values())
        and (params is None
             or (params.dtype == _F32 and params.device == dev
                 and params.is_contiguous()
                 and params.shape == (8, a0.shape[1])))
    ):
        U8, D = bank.shape
        Q = a0.shape[1]
        if (a0.shape[0] == U8 and live.shape[0] == D and 0 < D
                and D % LANE == 0 and 8 <= U8 <= MAX_ROWS and U8 % 8 == 0
                and Q >= 1
                and (dev.type == "cpu" or (bank.data_ptr() % 16 == 0
                                           and live.data_ptr() % 16 == 0))):
            return U8, Q, D
    _diagnose(mats, bank, live, params)
    raise ValueError("approx select refused its inputs")  # _diagnose raises


def _diagnose(mats: dict, bank, live, params):
    """Raise the error that names what the kernels do not take."""
    dev = bank.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"approx select runs on cpu or cuda tensors, not {dev}")
    tensors = dict(mats, bank=bank, live=live)
    if params is not None:
        tensors["params_t"] = params
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, bank on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.float32 if name in ("live", "params_t") else torch.bfloat16
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if bank.dim() != 2 or live.dim() != 1:
        raise ValueError("bank must be [U8, D] and live [D]")
    U8, D = bank.shape
    if D == 0 or D % LANE or live.shape[0] != D:
        raise ValueError(f"D ({D}) must be a positive multiple of {LANE} "
                         f"and live must have D entries, has {live.shape[0]}")
    if U8 < 8 or U8 % 8 or U8 > MAX_ROWS:
        raise ValueError(f"U8 ({U8}) must be a multiple of 8 in [8, {MAX_ROWS}]")
    Q = None
    for name, t in mats.items():
        if t.dim() != 2 or t.shape[0] != U8:
            raise ValueError(f"{name} shape {tuple(t.shape)} is not [U8={U8}, Q]")
        if Q is None:
            Q = t.shape[1]
        elif t.shape[1] != Q:
            raise ValueError(f"{name} has {t.shape[1]} queries, not {Q}")
    if Q < 1:
        raise ValueError("need at least one query")
    if params is not None and tuple(params.shape) != (8, Q):
        raise ValueError(f"params_t shape {tuple(params.shape)} != {(8, Q)}")
    if dev.type == "cuda" and (bank.data_ptr() % 16 or live.data_ptr() % 16):
        raise ValueError("bank and live must be 16-byte aligned")


def _chunks(Q: int, D: int):
    step = max(LANE, (_PLAIN_CHUNK_ELEMS // Q) // LANE * LANE)
    return [(d0, min(D, d0 + step)) for d0 in range(0, D, step)]


def _dot(a_t, rows):
    """[U8, Q] indicator x [U8, C] rows -> [Q, C] f32 products."""
    return a_t.float().T @ rows


def _select(mats, bank, live, params, match_of):
    """Plain phase 1 over doc chunks: ``match_of(products, presence)`` ->
    (score product, match mask), both [Q, C]. Tile max over every doc of
    the tile, gated to -1 where no doc matches (boolean forms)."""
    U8, Q, D = _check(mats, bank, live, params)
    tmax = torch.empty((Q, D // LANE), dtype=torch.float32, device=bank.device)
    hits = torch.zeros(Q, dtype=torch.int64, device=bank.device)
    for d0, d1 in _chunks(Q, D):
        rows = bank[:, d0:d1].float()
        ap, m = match_of(rows, live[d0:d1] > 0)
        g = ap.reshape(Q, -1, LANE).amax(dim=-1)
        if params is not None:
            g = torch.where(m.reshape(Q, -1, LANE).any(dim=-1), g, -1.0)
        tmax[:, d0 // LANE : d1 // LANE] = g
        hits += m.sum(dim=1)
    return tmax, hits.int()


def approx_select_reference(a_t, bank, live):
    """Plain PyTorch B3: (tile max rounded once to bf16, hits)."""

    def match_of(rows, alive):
        ap = _dot(a_t, rows)
        return ap, (ap > 0) & alive

    tmax, hits = _select({"a_t": a_t}, bank, live, None, match_of)
    return tmax.to(torch.bfloat16).float(), hits


def approx_select_bool_reference(a_sc_t, a_rq_t, a_sh_t, a_ng_t, bank,
                                 params_t, live):
    """Plain PyTorch B4: four products, presence = bank > 0."""
    nreq, msm = params_t[0][:, None], params_t[1][:, None]

    def match_of(rows, alive):
        pres = (rows > 0).float()
        rc, oc, nc = (_dot(a, pres) for a in (a_rq_t, a_sh_t, a_ng_t))
        m = (rc == nreq) & (oc >= msm) & (nc == 0) & ((rc + oc) > 0) & alive
        return _dot(a_sc_t, rows), m

    mats = {"a_sc_t": a_sc_t, "a_rq_t": a_rq_t, "a_sh_t": a_sh_t,
            "a_ng_t": a_ng_t}
    return _select(mats, bank, live, params_t, match_of)


def approx_select_bool2_reference(a_sc_t, a_cb_t, bank, params_t, live):
    """Plain PyTorch B5: the score product and one combined count product
    cc = rq*256 + sh, decoded with floor(cc * (1/256))."""
    nreq, msm = params_t[0][:, None], params_t[1][:, None]

    def match_of(rows, alive):
        cc = _dot(a_cb_t, (rows > 0).float())
        rc = torch.floor(cc * (1.0 / 256.0))
        oc = cc - rc * 256.0
        m = (rc == nreq) & (oc >= msm) & (cc > 0) & alive
        return _dot(a_sc_t, rows), m

    return _select({"a_sc_t": a_sc_t, "a_cb_t": a_cb_t}, bank, live,
                   params_t, match_of)


def packed_indicator_shape(U8: int, Q: int, matrices: int = 1,
                           pad_q: int = MMA_CHUNK_Q):
    """The tensor-core kernels' scratch: ``matrices`` indicators in MMA
    fragment order, int32 [matrices * F * ceil(U8 / 16) * 32, 4] (one
    16-byte row per lane and 16 x 16 fragment; csrc/approx_pass.cu
    pack_indicator_kernel), F the 16-query fragments of Q padded to a
    multiple of ``pad_q``: B3 (one matrix) pads to its 64-query chunks, B5
    (a_sc, then a_cb) and B4 (a_sc, a_rq, a_sh, a_ng) to one fragment."""
    frags = -(-Q // pad_q) * (pad_q // MMA_FRAG_Q)
    return (matrices * frags * -(-U8 // MMA_K) * 32, 4)


_launchers = {}  # launcher name -> ctypes function, looked up once


def _tensor_core_select(name, mats, bank, params, live, U8, Q, D, pad_q):
    """Launch B3, B4 or B5: (tile max f32 [Q, D/128], hits i32 [Q])."""
    fn = _launchers.get(name)
    if fn is None:
        fn = _launchers[name] = getattr(_build.library(), name)
    packed = bank.new_empty(packed_indicator_shape(U8, Q, len(mats), pad_q),
                            dtype=torch.int32)
    tmax = bank.new_empty((Q, D // LANE), dtype=_F32)
    hits = bank.new_empty(Q, dtype=torch.int32)
    ptrs = [m.data_ptr() for m in mats] + [bank.data_ptr()]
    if params is not None:
        ptrs.append(params.data_ptr())
    rc = fn(*ptrs, live.data_ptr(), packed.data_ptr(), tmax.data_ptr(),
            hits.data_ptr(), U8, Q, D,
            torch._C._cuda_getCurrentRawStream(bank.get_device()))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return tmax, hits


def approx_select(a_t, bank, live):
    """B3, pure-OR phase 1: (tile max f32 [Q, D/128] rounded once to bf16,
    hits i32 [Q]); a doc matches iff its product is positive and live."""
    U8, Q, D = _check({"a_t": a_t}, bank, live)
    if bank.device.type == "cpu":
        return approx_select_reference(a_t, bank, live)
    out = _tensor_core_select("diagon_approx_select", [a_t], bank, None, live,
                              U8, Q, D, MMA_CHUNK_Q)
    _LAUNCHES_B3.increment()
    return out


def approx_select_bool(a_sc_t, a_rq_t, a_sh_t, a_ng_t, bank, params_t,
                       live):
    """B4, general boolean phase 1 in four products on the tensor cores:
    (feasibility-gated tile max f32 [Q, D/128], exact hits i32 [Q])."""
    mats = {"a_sc_t": a_sc_t, "a_rq_t": a_rq_t, "a_sh_t": a_sh_t,
            "a_ng_t": a_ng_t}
    U8, Q, D = _check(mats, bank, live, params_t)
    if bank.device.type == "cpu":
        return approx_select_bool_reference(
            a_sc_t, a_rq_t, a_sh_t, a_ng_t, bank, params_t, live)
    out = _tensor_core_select("diagon_approx_select_bool", list(mats.values()),
                              bank, params_t, live, U8, Q, D, MMA_FRAG_Q)
    _LAUNCHES_B4.increment()
    return out


def approx_select_bool2(a_sc_t, a_cb_t, bank, params_t, live):
    """B5, no-MUST_NOT boolean phase 1 in two products on the tensor
    cores: as B4, from a_sc and the combined counts a_cb = rq * 256 + sh."""
    mats = {"a_sc_t": a_sc_t, "a_cb_t": a_cb_t}
    U8, Q, D = _check(mats, bank, live, params_t)
    if bank.device.type == "cpu":
        return approx_select_bool2_reference(a_sc_t, a_cb_t, bank, params_t,
                                             live)
    out = _tensor_core_select("diagon_approx_select_bool2", [a_sc_t, a_cb_t],
                              bank, params_t, live, U8, Q, D, MMA_FRAG_Q)
    _LAUNCHES_B5.increment()
    return out
