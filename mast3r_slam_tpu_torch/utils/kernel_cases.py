"""Seeded inputs that try to break ``refine_matches`` and
``coarse_correlate``: the CPU tests feed them to the JAX package and to the
plain versions, the GPU tests and ``chip_smoke.py`` feed them to the kernels.
Everything is made with numpy from a seed, so every consumer sees the same
values at the same size."""

from __future__ import annotations

import numpy as np

REFINE_KINDS = ("smooth", "random", "border", "nan", "ties", "inf",
                "extreme")
# kinds whose values an int8 cast cannot keep (NaN, 2^+-70)
BF16_ONLY_KINDS = ("nan", "extreme")


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def smooth_descriptors(b, h, w, f, rng, noise=0.02):
    """A descriptor field that varies smoothly with the pixel (sines of
    random plane waves) plus a little noise to break ties: neighbouring
    queries find neighbouring matches, as real descriptor maps behave."""
    v, u = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")
    k = rng.uniform(-0.35, 0.35, (b, 2, f)).astype(np.float32)
    ph = rng.uniform(0.0, 6.28, (b, 1, 1, f)).astype(np.float32)
    field = np.sin(u[None, ..., None] * k[:, None, None, 0]
                   + v[None, ..., None] * k[:, None, None, 1] + ph)
    field = field + noise * rng.standard_normal(field.shape)
    return _unit(field)


def tie_descriptors(b, h, w, f, rng, palette=4):
    """A (b, h, w, f) image whose pixels take one of ``palette`` vectors of
    multiples of 1/8 in [-3/8, 3/8] (feature 0 in [1/8, 3/8]): every
    product and sum is exact in any order and every window holds equal
    scores."""
    pal = rng.integers(-3, 4, (b, palette, f)).astype(np.float32) / 8.0
    pal[..., 0] = rng.integers(1, 4, (b, palette)) / 8.0
    pick = rng.integers(0, palette, (b, h, w))
    return np.take_along_axis(pal[:, None, None], pick[..., None, None],
                              axis=3)[..., 0, :]


def extreme_descriptors(b, h, w, f, rng):
    """Values of magnitude near 2^70 or 2^-70: each pixel all large, all
    small, or mixed value by value, so products overflow fp32 (2^140),
    underflow it (2^-140, subnormal or zero) or land near 1."""
    cls = rng.integers(0, 3, (b, h, w, 1))
    big = rng.integers(0, 2, (b, h, w, f)).astype(bool)
    big = np.where(cls == 0, False, np.where(cls == 1, True, big))
    e = np.where(big, 70, -70) + rng.integers(-2, 3, (b, h, w, f))
    m = rng.uniform(1.0, 2.0, (b, h, w, f)) * rng.choice([-1.0, 1.0],
                                                        (b, h, w, f))
    return np.ldexp(m, e).astype(np.float32)


def refine_case(kind, b, gh, gw, h, w, f, seed=0, jitter=4):
    """Inputs of ``refine_matches`` for a (gh, gw) query grid against an
    (h, w) descriptor image: D11 (b, h, w, f) and D21 (b, gh * gw, f)
    float32 (the caller casts to bf16 or int8), p1 (b, gh * gw, 2) int32.

    * ``smooth``: each query starts within ``jitter`` pixels of where its
      descriptor was sampled, so neighbouring windows overlap (the tracking
      case; ``jitter=0`` starts every query on its sample);
    * ``random``: uniformly random starts (scattered windows: the edges of a
      loop closure before any warm start);
    * ``border``: every start on the image border, the corners included
      (most taps fall outside the image);
    * ``nan``: the smooth case with NaNs planted in single values of D11 and
      of a few queries (a NaN score counts as the maximum);
    * ``ties``: ``tie_descriptors``, each query its true pixel's vector:
      equal exact scores inside every window (the first maximum wins);
    * ``inf``: ``ties`` with +-inf planted in single values of D11, -inf in
      feature 0 of some queries (every tap inside the image scores -inf:
      tap 0 wins) and +inf in another feature of a few: scores +-inf and
      NaN (inf x 0, inf - inf);
    * ``extreme``: ``extreme_descriptors``, each query its true pixel's
      values: products that overflow and underflow fp32, where a chain of
      FMAs and a chain of separate roundings part (bf16 only, as ``nan``).

    ``ties``, ``inf`` and ``extreme`` start as ``smooth`` does."""
    if kind not in REFINE_KINDS:
        raise ValueError(f"unknown refine case {kind!r}")
    rng = np.random.default_rng(seed)
    n = gh * gw
    if kind in ("ties", "inf"):
        D11 = tie_descriptors(b, h, w, f, rng)
    elif kind == "extreme":
        D11 = extreme_descriptors(b, h, w, f, rng)
    else:
        D11 = smooth_descriptors(b, h, w, f, rng)
    # the query grid looks at the image through a shifted, scaled window
    qv, qu = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    su, sv = (w - 1) / max(gw - 1, 1), (h - 1) / max(gh - 1, 1)
    tu = np.clip(np.round(qu * su * 0.9 + 0.05 * w), 0, w - 1).astype(int)
    tv = np.clip(np.round(qv * sv * 0.9 + 0.05 * h), 0, h - 1).astype(int)
    D21 = D11[:, tv, tu].reshape(b, n, f)
    if kind not in ("ties", "inf", "extreme"):
        D21 = _unit(D21 + 0.05 * rng.standard_normal(D21.shape))
    true = np.stack([tu, tv], -1).reshape(1, n, 2)
    if kind not in ("random", "border"):
        p1 = true + rng.integers(-jitter, jitter + 1, (b, n, 2))
        p1 = np.clip(p1, 0, [w - 1, h - 1])
    elif kind == "random":
        p1 = np.stack([rng.integers(0, w, (b, n)),
                       rng.integers(0, h, (b, n))], -1)
    else:
        side = rng.integers(0, 4, (b, n))
        along_u = rng.integers(0, w, (b, n))
        along_v = rng.integers(0, h, (b, n))
        u = np.where(side == 0, 0, np.where(side == 1, w - 1, along_u))
        v = np.where(side == 2, 0, np.where(side == 3, h - 1, along_v))
        v = np.where(side < 2, along_v, v)
        p1 = np.stack([u, v], -1)
        corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]])
        p1[:, :4] = corners[: min(4, n)][None, : min(4, n)]
    if kind == "nan":
        D11 = D11.copy()
        hits = max(4, (b * h * w) // 500)
        D11[rng.integers(0, b, hits), rng.integers(0, h, hits),
            rng.integers(0, w, hits), rng.integers(0, f, hits)] = np.nan
        qhits = max(2, n // 1000)
        D21[rng.integers(0, b, qhits), rng.integers(0, n, qhits),
            rng.integers(0, f, qhits)] = np.nan
    if kind == "inf":
        D11 = D11.copy()
        hits = max(4, (b * h * w) // 200)
        D11[rng.integers(0, b, hits), rng.integers(0, h, hits),
            rng.integers(0, w, hits), rng.integers(0, f, hits)] = (
                rng.choice([-np.inf, np.inf], hits))
        qhits = max(2, n // 50)
        D21[rng.integers(0, b, qhits), rng.integers(0, n, qhits), 0] = -np.inf
        D21[rng.integers(0, b, qhits), rng.integers(0, n, qhits),
            rng.integers(1, f, qhits)] = np.inf
    return (np.ascontiguousarray(D11, np.float32),
            np.ascontiguousarray(D21, np.float32),
            np.ascontiguousarray(p1, np.int32))


def coarse_edge_case(b, h, w, f, n, stride, seed=0):
    """Inputs of ``coarse_correlate`` with rows whose answer is known:
    D11 (b, h, w, f) and D21 (b, n, f) float32 holding bf16 values, and
    ``expect``, a list of (batch, row, coarse cell). Needs n >= 8 and at
    least 12 coarse cells.

    * row 1 of every batch item: twice a cell's descriptor, a unique winner;
    * row 3 of item 0: a NaN query, every score NaN, the first cell wins;
    * row 5 of every item: a zero query, every score ties, the first cell;
    * row 7 of item 0: scores <= 0 with an exact 0 in two cells, the lower
      cell wins (a maximum of zero, neither the first cell nor unique);
    * with b >= 2, item 1 has a NaN in one cell's descriptor: that cell is
      the first NaN score of every row of the item."""
    import torch

    rng = np.random.default_rng(seed)
    bf16 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()
    D11 = _unit(rng.standard_normal((b, h, w, f)))
    D21 = bf16(_unit(rng.standard_normal((b, n, f))))
    hc, wc = -(-h // stride), -(-w // stride)
    nc = hc * wc
    # item 0: feature 0 negative in every cell but two, where it is zero
    z1, z2 = nc // 3, nc // 3 + 2
    f0 = D11[0, ::stride, ::stride, 0]            # a view of feature 0
    f0[...] = -np.abs(f0) - 2.0 ** -6
    for z in (z1, z2):
        D11[0, (z // wc) * stride, (z % wc) * stride, 0] = 0.0
    D11 = bf16(D11)
    cells = D11[:, ::stride, ::stride]            # a view: writes go through
    expect = []
    D21[0, 7] = 0.0
    D21[0, 7, 0] = 1.0
    expect.append((0, 7, z1))
    D21[0, 3] = np.nan
    expect.append((0, 3, 0))
    win = nc // 2 + 1
    for i in range(b):
        D21[i, 1] = 2.0 * cells[i, win // wc, win % wc]
        D21[i, 5] = 0.0
        expect += [(i, 1, win), (i, 5, 0)]
    if b >= 2:
        c_nan = nc // 4 + 1
        cells[1, c_nan // wc, c_nan % wc, f // 2] = np.nan
        expect = [e for e in expect if e[0] != 1]
        expect += [(1, r, c_nan) for r in range(n)]
    return D11, D21, expect


def cell_center(cell, h, w, stride):
    """Coarse cell -> the full-resolution linear index ``coarse_correlate``
    returns for it."""
    wc = -(-w // stride)
    u = min((cell % wc) * stride + stride // 2, w - 1)
    v = min((cell // wc) * stride + stride // 2, h - 1)
    return v * w + u


def dpt_conv_shapes(cfg, b):
    """Every ``layers.conv2d`` call of one ``dpt.head_forward`` of network
    ``cfg`` at batch ``b``, in call order, traced on the meta device (no
    memory, no arithmetic): tuples (x shape (b, c, h, w), weight shape
    (n, c, r, s), stride, padding, has_bias). The 3xTF32 conv kernel's
    tests and ``chip_smoke.py`` run it at these shapes."""
    from unittest import mock

    import torch

    from ..models import dpt

    with torch.device("meta"):
        head = dpt.Head(cfg)
    n_dec = cfg.dec_depth
    hooks = (0, n_dec * 2 // 4, n_dec * 3 // 4, n_dec)
    grid = (cfg.img_size[0] // cfg.patch_size,
            cfg.img_size[1] // cfg.patch_size)
    n = grid[0] * grid[1]
    tokens = [torch.empty(b, n, cfg.enc_embed_dim, device="meta")] + [
        torch.empty(b, n, cfg.dec_embed_dim, device="meta")
        for _ in range(n_dec)]
    calls = []
    conv2d = dpt.conv2d

    def record(mod, x, dtype=None, stride=1, padding=None):
        w = mod.weight
        calls.append((tuple(x.shape), tuple(w.shape), stride,
                      w.shape[-1] // 2 if padding is None else padding,
                      mod.bias is not None))
        return conv2d(mod, x, dtype=dtype, stride=stride, padding=padding)

    with mock.patch.object(dpt, "conv2d", record):
        dpt.head_forward(head, tokens, grid, cfg.patch_size, cfg.desc_dim,
                         hooks, cfg.head_compute_dtype)
    return calls
