"""Emulated on the CPU: the RMNP kernel (``csrc/rmnp_update.cu``).

The emulation, its headers and models, and the build fixtures are in
``tests/_torch_emulation.py``, which says what they check and cannot check.
"""
import numpy as np
import pytest

from _torch_emulation import (  # noqa: F401 — rmnp_lib: the fixtures' dependency
    BETA, EPS, GPT2_SMALL_BUCKETS, RMNP_CASES, _as_f32, _bf16, _case_id, _layout, _rmnp,
    _rmnp_model, _rmnp_operands, _rmnp_split, rmnp_f32, rmnp_lib, rmnp_split_f32)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("case", RMNP_CASES, ids=_case_id)
def test_emulated_rmnp_sum_of_squares_in_its_own_order(rmnp_f32, case):
    """The precondition kernel's v_new and d equal the numpy model of its own
    order of the sum of squares, bit for bit."""
    from repro_torch.kernels.rmnp_update import split
    shape, layout, v_bf16 = case
    layout = _layout(*layout) if layout else split(*shape[-2:])
    g, v, _ = _rmnp_operands(shape, v_bf16)
    v_new, d = _rmnp(rmnp_f32, g, v, layout=layout)
    want_v, want_d = _rmnp_model(g, _as_f32(v), layout)
    assert np.array_equal(v_new, _bf16(want_v) if v_bf16 else want_v)
    assert np.array_equal(d, want_d)


@pytest.mark.parametrize("case", RMNP_CASES[:-1], ids=_case_id)
def test_emulated_rmnp_stack_equals_slices(rmnp_f32, case):
    """Each slice of a stacked launch, precondition and apply, equals that
    slice launched alone, bit for bit."""
    shape, layout, v_bf16 = case
    layout = _layout(*layout)
    g, v, w = _rmnp_operands(shape, v_bf16, w_bf16=not v_bf16)
    for apply in (False, True):
        stacked = _rmnp(rmnp_f32, g, v, w if apply else None, layout=layout)
        for i in range(shape[0]):
            one = _rmnp(rmnp_f32, g[i:i + 1].copy(), v[i:i + 1].copy(),
                        w[i:i + 1].copy() if apply else None, layout=layout)
            for a, b in zip(stacked, one, strict=True):
                assert np.array_equal(a[i], b[0]), (apply, i)


@pytest.mark.parametrize("case", RMNP_CASES, ids=_case_id)
@pytest.mark.parametrize("w_bf16", [False, True], ids=["w32", "w16"])
def test_emulated_rmnp_apply_equals_precondition_then_eager_ops(rmnp_f32, case, w_bf16):
    """fp32 momentum: apply's (v_new, w_new) equal the precondition's v_new
    and ``w + (-scale) * (d + wd * w)`` in float32 from its d, each
    operation rounded (then rounded to bf16 for bf16 weights), bit for bit."""
    from repro_torch.kernels.rmnp_update import split
    shape, layout, _ = case
    layout = _layout(*layout) if layout else split(*shape[-2:])
    g, v, w = _rmnp_operands(shape, False, w_bf16=w_bf16)
    scale, wd = np.float32(2e-3), np.float32(0.1)
    v_apply, w_apply = _rmnp(rmnp_f32, g, v, w, scalars=(scale, wd), layout=layout)
    v_pre, d = _rmnp(rmnp_f32, g, v, layout=layout)
    w32 = _as_f32(w)
    eager = w32 + (-scale) * (d + wd * w32)
    assert np.array_equal(v_apply, v_pre)
    assert np.array_equal(w_apply, _bf16(eager) if w_bf16 else eager)


@pytest.mark.parametrize("case", RMNP_CASES, ids=_case_id)
@pytest.mark.parametrize("w_bf16", [False, True], ids=["w32", "w16"])
def test_emulated_rmnp_matches_plain(rmnp_f32, case, w_bf16):
    """Against the plain versions (torch, CPU) at the tolerances of
    tests/test_torch_gpu.py: fp32 rtol 1e-5, bf16 one bf16 step (2^-7),
    atol 1e-6."""
    import torch

    from repro_torch.kernels import rmnp_update as rm
    shape, layout, v_bf16 = case
    layout = _layout(*layout) if layout else None
    g, v, w = _rmnp_operands(shape, v_bf16, w_bf16)
    scalars = (2e-3, 0.1)

    def torch_of(x):
        t = torch.from_numpy(_as_f32(x).copy())
        return t.to(torch.bfloat16) if x.dtype == np.uint16 else t

    tg, tv, tw = torch_of(g), torch_of(v), torch_of(w)
    want = {"precondition": rm.rmnp_rownorm_plain(tg, tv, beta=BETA, eps=EPS),
            "apply": rm.rmnp_rownorm_apply_plain(tg, tv, tw, torch.tensor(scalars), beta=BETA,
                                                 eps=EPS)}
    got = {"precondition": _rmnp(rmnp_f32, g, v, layout=layout),
           "apply": _rmnp(rmnp_f32, g, v, w, scalars=scalars, layout=layout)}
    for kind in want:
        for a, b in zip(got[kind], want[kind], strict=True):
            bf16 = b.dtype == torch.bfloat16
            assert (a.dtype == np.uint16) == bf16, kind
            torch.testing.assert_close(torch.from_numpy(_as_f32(a)), b.float(),
                                       rtol=2.0 ** -7 if bf16 else 1e-5, atol=1e-6)


def test_emulated_rmnp_paths_agree_bitwise(rmnp_f32):
    """Masked element loads and aligned vector loads, and the two-sweep path
    and the one-read path of one split, give the same bits."""
    g, v, w = _rmnp_operands((2, 90, 40), True, w_bf16=True)
    one = _layout(2, 45, 32, 64)
    two = _layout(2, 45, 32, 64, one_read=False)
    for apply in (False, True):
        ww = w if apply else None
        ref = _rmnp(rmnp_f32, g, v, ww, layout=one)
        for layout, vec in ((one, False), (two, True), (two, False)):
            got = _rmnp(rmnp_f32, g, v, ww, layout=layout, vec=vec)
            for a, b in zip(got, ref, strict=True):
                assert np.array_equal(a, b), (apply, layout, vec)


@pytest.mark.parametrize("d_in,d_out", [(768, 768), (768, 6144), (3072, 768), (50432, 768),
                                        (33, 9), (300, 257), (6145, 64), (8192, 50),
                                        (102400, 16), (250000, 768)])
def test_rmnp_split(d_in, d_out):
    """The split covers d_in, fits a block's shared memory, is a function
    of (d_in, d_out) alone, and reads once wherever a cluster can hold the
    column block (always for gpt2-small's buckets)."""
    import inspect

    from repro_torch.kernels import rmnp_update as rm
    assert list(inspect.signature(rm.split).parameters) == ["d_in", "d_out"]
    s = rm.split(d_in, d_out)
    assert s.K * s.R >= d_in and (s.K - 1) * s.R < d_in  # no block without rows
    assert 1 <= s.K <= rm.MAX_CLUSTER and s.C in rm.COLUMNS
    assert s.threads % (s.C // 4) == 0 and s.threads <= 512
    assert s.smem_bytes() <= rm.SMEM_LIMIT
    if s.K > rm.MAX_PORTABLE_CLUSTER:
        assert s.one_read
    if not s.one_read:  # only where no cluster of 16 can hold 8 columns
        assert s.C == 32 and rm.Split(16, -(-d_in // 16), 8, s.threads, True).smem_bytes() \
            > rm.SMEM_LIMIT
    if (d_in, d_out) in [b[1:] for b in GPT2_SMALL_BUCKETS]:
        assert s.one_read
    if (d_in, d_out) == (50432, 768):
        assert s == rm.Split(16, 3152, 16, rm.TALL_THREADS, True)


# ------------------------------------------------- the column-split modes ---
# PARTIAL and FINISH (the model axis: d_in rows split over ranks) are the
# two-sweep path cut at the cluster's reduction.

@pytest.mark.parametrize("case", RMNP_CASES, ids=_case_id)
@pytest.mark.parametrize("w_bf16", [False, True], ids=["w32", "w16"])
def test_emulated_rmnp_split_modes_on_one_rank_equal_the_one_pass(rmnp_f32, rmnp_split_f32,
                                                                 case, w_bf16):
    """PARTIAL's column sums fed straight to FINISH (a group of one) give the
    one-pass kernel's v_new, d and w_new bit for bit, at each momentum type."""
    from repro_torch.kernels.rmnp_update import split
    shape, layout, v_bf16 = case
    layout = _layout(*layout) if layout else split(*shape[-2:])
    g, v, w = _rmnp_operands(shape, v_bf16, w_bf16=w_bf16)
    two = layout._replace(one_read=False)
    sums = _rmnp_split(rmnp_split_f32, g, v, layout=two)
    for ww in (None, w):
        want = _rmnp(rmnp_f32, g, v, ww, layout=layout)
        got = _rmnp_split(rmnp_split_f32, g, v, sums, ww, layout=two)
        for a, b in zip(got, want, strict=True):
            assert np.array_equal(a, b), (ww is not None)


@pytest.mark.parametrize("case", RMNP_CASES, ids=_case_id)
def test_emulated_rmnp_split_modes_match_plain(rmnp_split_f32, case):
    """PARTIAL and FINISH against their plain versions (torch, CPU) at the
    tolerances of tests/test_torch_gpu.py: fp32 rtol 1e-5, bf16 one bf16
    step (2^-7), atol 1e-6; the column sums at rtol 1e-5."""
    import torch

    from repro_torch.kernels import rmnp_update as rm
    shape, layout, v_bf16 = case
    layout = (_layout(*layout) if layout else rm.split(*shape[-2:]))._replace(one_read=False)
    g, v, w = _rmnp_operands(shape, v_bf16, w_bf16=not v_bf16)

    def torch_of(x):
        t = torch.from_numpy(_as_f32(x).copy())
        return t.to(torch.bfloat16) if x.dtype == np.uint16 else t

    tg, tv, tw = torch_of(g), torch_of(v), torch_of(w)
    sums = _rmnp_split(rmnp_split_f32, g, v, layout=layout)
    torch.testing.assert_close(torch.from_numpy(sums), rm.rmnp_rownorm_partial_plain(
        tg, tv, beta=BETA), rtol=1e-5, atol=0)
    total = torch.from_numpy(sums)
    for ww, tww in ((None, None), (w, tw)):
        got = _rmnp_split(rmnp_split_f32, g, v, sums, ww, layout=layout)
        want = rm.rmnp_rownorm_finish_plain(tg, tv, total, tww, torch.tensor((2e-3, 0.1)),
                                            beta=BETA, eps=EPS)
        for a, b in zip(got, want, strict=True):
            bf16 = b.dtype == torch.bfloat16
            torch.testing.assert_close(torch.from_numpy(_as_f32(a)), b.float(),
                                       rtol=2.0 ** -7 if bf16 else 1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 90, 40), (1, 256, 24), (3, 66, 12)])
def test_emulated_rmnp_two_row_halves_match_the_whole(rmnp_f32, rmnp_split_f32, shape):
    """Two ranks' halves of d_in (each its own split): PARTIAL on each, the
    sums added in rank order, FINISH on each, stacked, against the one-pass
    kernel on the whole matrix within fp32 tolerance; and the plain versions
    of the halves likewise against the whole."""
    import torch

    from repro_torch.kernels import rmnp_update as rm
    g, v, w = _rmnp_operands(shape, False, w_bf16=False)
    h = shape[-2] // 2
    halves = [(np.ascontiguousarray(x[..., :h, :]), np.ascontiguousarray(x[..., h:, :]))
              for x in (g, v, w)]
    sums = [_rmnp_split(rmnp_split_f32, halves[0][i], halves[1][i],
                        layout=rm.split_layout(h, shape[-1])) for i in range(2)]
    total = sums[0] + sums[1]
    got = [_rmnp_split(rmnp_split_f32, halves[0][i], halves[1][i], total, halves[2][i],
                       layout=rm.split_layout(h, shape[-1])) for i in range(2)]
    v_whole, w_whole = _rmnp(rmnp_f32, g, v, w)
    np.testing.assert_array_equal(np.concatenate([got[0][0], got[1][0]], axis=-2), v_whole)
    np.testing.assert_allclose(np.concatenate([got[0][1], got[1][1]], axis=-2), w_whole,
                               rtol=1e-5, atol=1e-6)
    t = [tuple(torch.from_numpy(x[i]) for x in halves) for i in range(2)]
    plain_total = sum(rm.rmnp_rownorm_partial_plain(tg, tv, beta=BETA) for tg, tv, _ in t)
    plain = [rm.rmnp_rownorm_finish_plain(tg, tv, plain_total, tw, torch.tensor((2e-3, 0.1)),
                                          beta=BETA, eps=EPS)[1] for tg, tv, tw in t]
    whole = rm.rmnp_rownorm_apply_plain(torch.from_numpy(g), torch.from_numpy(v),
                                        torch.from_numpy(w), torch.tensor((2e-3, 0.1)),
                                        beta=BETA, eps=EPS)[1]
    torch.testing.assert_close(torch.cat(plain, dim=-2), whole, rtol=1e-5, atol=1e-6)
