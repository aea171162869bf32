"""Port dense matcher == the JAX package's ``ops/dense_matcher.py``.

``coarse_correlate`` rounds the score to bf16 before the argmax, so its
ties are bf16 ties, and the fp32 accumulation order over the features (XLA
on the CPU here, a fixed feature order in the port) can flip a rounding.
The stated rule, for the same seeded numpy inputs through both packages:

* the cell each side chose holds that row's maximum score as the other side
  computes the scores (checked with the port's bf16 score matrix on every
  row, and with a float64 score to one bf16 ulp for the JAX choice);
* where a row has a planted unique winner the indices are exactly equal;
* a NaN row gives the first cell (``argmax`` treats NaN as the maximum and
  takes the first), an all-equal row the first cell.

On the GPU the product runs on the tensor cores, with no fixed summation order
either, so the port's own check of its kernel is the same kind of rule:
``dense_matcher.tie_rule_violations`` / ``check_coarse_correlate``. Here the
rule is tested on hand-made scores, and the JAX function is held to it
against the port's plain scores on inputs with known answers
(``utils/kernel_cases.coarse_edge_case``).

``match_dense`` is then compared on the fixtures of
``tests/test_dense_matcher.py``: indices equal at >= 99.9% of the pixels
(observed: all) and valid flags at >= 99% (observed: 99.35%, whole 2x2
blocks of the coarse LM subgrid near the image border: XLA fuses the LM's
multiply-adds, which moves a coarse point across the occlusion gate's
threshold, the difference ``tests/test_torch_factor_graph.py`` describes).
The three accuracy cases of that file hold for the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import dense_matcher as jdm
from mast3r_slam_tpu_torch.ops import dense_matcher as tdm
from mast3r_slam_tpu_torch.ops import matching as tmatching

from test_dense_matcher import _shifted_world

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    """numpy fp32 -> the same values rounded to bf16, as fp32."""
    return _t(a).to(torch.bfloat16).to(torch.float32).numpy()


def _descriptors(b, h, w, f, n, seed):
    rng = np.random.default_rng(seed)
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    D11 = _bf16(unit(rng.standard_normal((b, h, w, f))).astype(np.float32))
    D21 = _bf16(unit(rng.standard_normal((b, n, f))).astype(np.float32))
    return D11, D21


def _both(D21, D11, stride):
    cj = np.asarray(jdm.coarse_correlate(
        jnp.asarray(D21).astype(jnp.bfloat16),
        jnp.asarray(D11).astype(jnp.bfloat16), stride))
    ct = tdm.coarse_correlate(_t(D21).to(torch.bfloat16),
                              _t(D11).to(torch.bfloat16), stride)
    assert ct.dtype == torch.int32 and ct.shape == cj.shape
    return cj, ct.numpy()


def _cells(idx, w, stride):
    """Full-resolution index of a cell center -> coarse cell index."""
    wc = -(-w // stride)
    return (idx // w) // stride * wc + (idx % w) // stride


@pytest.mark.parametrize("b,h,w,f,n,stride", [(2, 32, 48, 16, 384, 4),
                                              (1, 64, 96, 8, 1536, 4),
                                              (2, 30, 50, 24, 200, 4),
                                              (1, 16, 24, 8, 96, 2)])
def test_coarse_correlate_plain_matches_jax_under_tie_rule(b, h, w, f, n,
                                                           stride):
    D11, D21 = _descriptors(b, h, w, f, n, seed=h + f)
    cj, ct = _both(D21, D11, stride)
    scores = tdm.coarse_scores_plain(_t(D21).to(torch.bfloat16),
                                     _t(D11).to(torch.bfloat16),
                                     stride).numpy()          # (b, n, cells)
    row_max = scores.max(-1)
    take = lambda idx: np.take_along_axis(
        scores, _cells(idx, w, stride)[..., None], -1)[..., 0]
    # the port's choice is a maximum of the port's scores: exactly
    np.testing.assert_array_equal(take(ct), row_max)
    # the JAX choice is a maximum up to one bf16 rounding of the score
    assert np.all(row_max - take(cj) <= 2.0 ** -8 * np.abs(row_max) + 1e-30)
    same = (cj == ct).mean()
    print(f"identical indices: {same:.4f}")
    assert same >= 0.99


def test_coarse_correlate_planted_winner_nan_and_ties_equal_jax():
    b, h, w, f, n, stride = 2, 32, 48, 16, 64, 4
    D11, D21 = _descriptors(b, h, w, f, n, seed=11)
    hc, wc = h // stride, w // stride
    rng = np.random.default_rng(12)
    cells = rng.integers(0, hc * wc, (b, n))
    # every query is twice its target cell's descriptor: score 2 against
    # at most 2 * 0.9 elsewhere, a unique winner whatever the rounding
    Dc = D11[:, ::stride, ::stride].reshape(b, hc * wc, f)
    D21 = 2.0 * np.take_along_axis(Dc, cells[..., None], 1)
    D21[0, 7] = np.nan            # NaN scores in every cell
    D21[1, 9] = 0.0               # every score ties at 0
    cj, ct = _both(D21, D11, stride)
    np.testing.assert_array_equal(ct, cj)
    vc, uc = cells // wc, cells % wc
    expect = (vc * stride + stride // 2) * w + uc * stride + stride // 2
    first = (stride // 2) * w + stride // 2
    expect[0, 7] = expect[1, 9] = first
    np.testing.assert_array_equal(ct, expect)


def test_coarse_correlate_reads_the_strided_grid_and_clamps_centers():
    """h, w not multiples of the stride: ceil(h / s) x ceil(w / s) cells,
    and a last cell's center is clamped into the image."""
    b, h, w, f, stride = 1, 10, 14, 8, 4
    D11, _ = _descriptors(b, h, w, f, 4, seed=2)
    Dc = D11[:, ::stride, ::stride]
    assert Dc.shape[1:3] == (3, 4)
    D21 = 2.0 * Dc.reshape(b, 12, f)
    cj, ct = _both(D21, D11, stride)
    np.testing.assert_array_equal(ct, cj)
    # cell (2, 3): v = min(8 + 2, 9) = 9, u = min(12 + 2, 13) = 13
    assert ct[0, 11] == 9 * w + 13


def _scores(rows):
    """(1, r, cells) fp32 scores that hold bf16 values."""
    return torch.tensor([rows], dtype=torch.float32).to(
        torch.bfloat16).to(torch.float32)


STEP = 2.0 ** -7          # one bf16 step for scores in [1, 2)


@pytest.mark.parametrize("case,rows,cells,expect", [
    # a tie that a one-step rounding flip moved to the other cell: accepted
    ("one_step_tie_flip", [[1.0, 1.0 + STEP, 1.0 + STEP, 0.5]], [2],
     dict(score_off=0, unique_moved=0, nan_wrong=0, identical=0)),
    # the chosen score is one step below a unique-by-one-step maximum
    ("one_step_below", [[1.0, 1.0 + STEP, 0.5, 0.25]], [0],
     dict(score_off=0, unique_moved=0, nan_wrong=0, identical=0)),
    # two steps below the maximum: rejected on both counts
    ("two_step_miss", [[1.0, 1.0 + 2 * STEP, 0.5, 0.25]], [0],
     dict(score_off=1, unique_moved=1, nan_wrong=0, identical=0)),
    # the maximum is unique by two steps and was chosen
    ("unique_kept", [[1.0, 1.0 + 2 * STEP, 0.5, 0.25]], [1],
     dict(score_off=0, unique_moved=0, nan_wrong=0, identical=1)),
    # +0 and -0 are the same score; the first of them is the plain argmax
    ("signed_zero_tie", [[-1.0, -0.0, 0.0, -2.0]], [2],
     dict(score_off=0, unique_moved=0, nan_wrong=0, identical=0)),
    # a NaN score wins, the first NaN cell is the answer
    ("nan_first", [[3.0, float("nan"), float("nan"), 9.0]], [1],
     dict(score_off=0, unique_moved=0, nan_wrong=0, identical=1)),
    ("nan_second_is_wrong", [[3.0, float("nan"), float("nan"), 9.0]], [2],
     dict(score_off=0, unique_moved=0, nan_wrong=1, identical=0)),
    ("nan_row_number_is_wrong", [[3.0, float("nan"), 1.0, 9.0]], [3],
     dict(score_off=0, unique_moved=0, nan_wrong=1, identical=0)),
])
def test_tie_rule_on_hand_made_scores(case, rows, cells, expect):
    got = tdm.tie_rule_violations(_scores(rows), torch.tensor([cells]))
    assert {k: got[k] for k in expect} == expect, (case, got)
    assert got["rows"] == 1


@pytest.mark.parametrize("b,h,w,f,n,stride", [(2, 32, 48, 24, 101, 4),
                                              (1, 30, 50, 8, 77, 4),
                                              (2, 16, 24, 32, 96, 2)])
def test_jax_coarse_correlate_meets_the_ports_tie_rule(b, h, w, f, n, stride):
    """The rule the GPU kernel is held to, applied to the JAX function: its
    choices against the port's plain scores, and exact indices on the rows
    whose answer is known (NaN query, all-equal row, a maximum of exactly
    zero, a NaN cell, a planted winner)."""
    from mast3r_slam_tpu_torch.utils import kernel_cases

    D11, D21, expect = kernel_cases.coarse_edge_case(b, h, w, f, n, stride,
                                                     seed=h + f)
    cj, ct = _both(D21, D11, stride)
    tD21, tD11 = _t(D21).to(torch.bfloat16), _t(D11).to(torch.bfloat16)
    for got in (cj, ct):
        chk = tdm.check_coarse_correlate(_t(got), tD21, tD11, stride)
        assert (chk["score_off"], chk["unique_moved"], chk["nan_wrong"]) == (
            0, 0, 0), chk
        assert chk["identical_share"] >= 0.99
        for i, r, cell in expect:
            assert got[i, r] == kernel_cases.cell_center(cell, h, w, stride)


@pytest.mark.parametrize("qs", [1, 4])
@pytest.mark.parametrize("seed,du,dv,dist", [(0, 9, 5, 0.5), (1, 12, 7, 0.1)])
def test_match_dense_matches_jax(seed, du, dv, dist, qs):
    X11, X21, D11, D21 = _shifted_world(jax.random.PRNGKey(seed), 32, 48,
                                        du, dv)
    ij, vj = jdm.match_dense(X11, X21, D11, D21, stride=4, dist_thresh=dist,
                             query_stride=qs)
    it, vt = tdm.match_dense(_t(X11), _t(X21), _t(D11), _t(D21), stride=4,
                             dist_thresh=dist, query_stride=qs)
    assert it.shape == (1, 32 * 48) and vt.shape == (1, 32 * 48, 1)
    assert vt.dtype == torch.bool
    assert (it.numpy() == np.asarray(ij)).mean() >= 0.999
    assert (vt.numpy() == np.asarray(vj)).mean() >= 0.99


def _interior(uv, du, dv, h, w):
    eu, ev = uv[:, 0] + du, uv[:, 1] + dv
    return ((eu >= 4) & (eu < w - 4) & (ev >= 4) & (ev < h - 4)
            & (uv[:, 0] >= 4) & (uv[:, 1] >= 4) & (uv[:, 0] < w - 4)
            & (uv[:, 1] < h - 4))


def test_dense_matcher_recovers_large_shift():
    h, w, du, dv = 32, 48, 9, 5
    X11, X21, D11, D21 = _shifted_world(jax.random.PRNGKey(0), h, w, du, dv)
    idx, _ = tdm.match_dense(_t(X11), _t(X21), _t(D11), _t(D21), stride=4,
                             dist_thresh=0.5)
    uv = tmatching.lin_to_pixel(torch.arange(h * w), w).numpy()
    got = tmatching.lin_to_pixel(idx[0], w).numpy()
    inside = _interior(uv, du, dv, h, w)
    err = (np.abs(got[:, 0] - uv[:, 0] - du)
           + np.abs(got[:, 1] - uv[:, 1] - dv))[inside]
    assert np.mean(err <= 1) > 0.8


def test_dense_matcher_large_motion_accuracy():
    h, w, du, dv = 32, 48, 12, 7
    X11, X21, D11, D21 = _shifted_world(jax.random.PRNGKey(1), h, w, du, dv)
    idx, valid = tdm.match_dense(_t(X11), _t(X21), _t(D11), _t(D21),
                                 stride=4, dist_thresh=0.1)
    assert float(valid.float().mean()) > 0.3
    uv = tmatching.lin_to_pixel(torch.arange(h * w), w).numpy()
    expect = (uv[:, 1] + dv) * w + uv[:, 0] + du
    inside = ((uv[:, 0] + du < w - 4) & (uv[:, 1] + dv < h - 4)
              & (uv[:, 0] >= 4) & (uv[:, 1] >= 4))
    assert np.mean((idx[0].numpy() == expect)[inside]) > 0.5


def test_dense_matcher_query_stride():
    h, w, du, dv, qs = 32, 48, 9, 5, 4
    X11, X21, D11, D21 = _shifted_world(jax.random.PRNGKey(0), h, w, du, dv)
    idx, valid = tdm.match_dense(_t(X11), _t(X21), _t(D11), _t(D21),
                                 stride=4, dist_thresh=0.5, query_stride=qs)
    assert idx.shape == (1, h * w) and valid.shape == (1, h * w, 1)
    v = valid[0, :, 0].numpy().reshape(h, w)
    assert not v[:, np.arange(w) % qs != 0].any()      # off-subset False
    assert v[:, ::qs].mean() > 0.5                     # subset mostly valid
    uv = tmatching.lin_to_pixel(torch.arange(h * w), w).numpy()
    got = tmatching.lin_to_pixel(idx[0], w).numpy()
    inside = _interior(uv, du, dv, h, w) & (uv[:, 0] % qs == 0)
    err = (np.abs(got[:, 0] - uv[:, 0] - du)
           + np.abs(got[:, 1] - uv[:, 1] - dv))[inside]
    assert np.mean(err <= 1) > 0.8
