"""The exact C8 steerable-filter basis, to import ReResNet checkpoints
that carry basis coefficients.

A numpy copy of `jdet_tpu/models/equivariant/c8_basis.py`
(`c8_sampled_basis` :167, `expand_filter` :242), kept in the port so that
it imports nothing of the JAX package; the two are held equal by
`tests/test_torch_pretrained.py`.

The reference's R2Conv stores its learnable parameters as coefficients
over a steerable kernel basis (`python/jdet/models/equivalent_modules/
e2conv.py:258` `self.weights`); the expanded `filter` buffer is only
materialized by an eval() pass. A checkpoint saved in train mode
therefore carries ONLY the coefficients, and importing it requires
re-building the exact basis the reference builds:

  - grid + rings + sigmas:   e2conv.py:471 `compute_basis_params`
    (ReResNet always passes `frequencies_cutoff=lambda r: 3 * r`,
    re_resnet.py:418, equivalent_modules.py:24-60)
  - angular solutions:       utils/equivalent/kernels/irreps_basis.py:31
    `R2DiscreteRotationsSolution` (Table 11 of "General E(2)-Equivariant
    Steerable CNNs", specialized to C8 irrep pairs)
  - direct sum + change of basis to the regular representation:
    kernels/steerable_basis.py:131, representation.py:433
  - Gaussian radial profile tensor product: kernels/basis.py:137,230
  - normalization + near-zero element pruning:
    models/equivalent_modules/block_basis.py:12,58

Specialized to the only cases ReResNet/ReFPN use: the C8 fiber group,
regular and trivial fields, square kernels, dilation 1, default rings/
sigma, fco(r) = 3r.
"""
from __future__ import annotations

import math

import numpy as np

N = 8  # cyclic group order (C8)

# irreps of C8 in the order the reference builds them (cyclic_group.py:36):
# (frequency, size); the regular representation contains each exactly once.
IRREPS = [(0, 1), (1, 2), (2, 2), (3, 2), (4, 1)]
REGULAR_SIZE = 8


def grid_coords(k: int, dilation: int = 1) -> np.ndarray:
    """(2, k*k) sampling points, raster order, math-oriented y axis
    (e2conv.py:390 get_grid_coords)."""
    actual = dilation * (k - 1) + 1
    origin = actual / 2 - 0.5
    pts = []
    for y in range(k):
        for x in range(k):
            pts.append((x * dilation - origin, -y * dilation + origin))
    return np.asarray(pts, dtype=np.float64).T


def basis_params(k: int):
    """rings, sigmas and the per-ring frequency cutoff for ReResNet's
    convs (compute_basis_params with frequencies_cutoff = 3r)."""
    n_rings = math.ceil(k / 2)
    rings = [float(r) for r in np.linspace(0, (k - 1) // 2, n_rings)]
    sigma = [0.6] * (len(rings) - 1) + [0.4]
    for i, r in enumerate(rings):
        if r == 0.0:
            sigma[i] = 0.005
    fco = lambda r: 3.0 * r  # noqa: E731
    max_freq = int(max(fco(r) for r in rings))
    return rings, sigma, fco, max_freq


def regular_change_of_basis() -> np.ndarray:
    """(8, 8) orthonormal map from the irrep direct-sum basis to the
    regular basis (representation.py:433 build_regular_representation):
    row e = [1, √2cos(eθ), √2sin(eθ), √2cos(2eθ), √2sin(2eθ),
             √2cos(3eθ), √2sin(3eθ), cos(4eθ)] / √8,  θ = 2π/8.
    """
    th = 2.0 * np.pi / N
    Q = np.zeros((N, N))
    for e in range(N):
        row = [1.0]
        for f in (1, 2, 3):
            row += [math.sqrt(2) * math.cos(f * e * th),
                    math.sqrt(2) * math.sin(f * e * th)]
        row.append(math.cos(4 * e * th))
        Q[e] = row
    return Q / math.sqrt(N)


def _offsets(base: int, max_freq: int, non_negative: bool = False):
    """Frequency offsets t with |base + tN| <= max_freq
    (math_utils.py:44 offset_iterator)."""
    lo = (0 if non_negative else -max_freq) - base
    t0 = math.ceil(lo / N)
    t1 = math.floor((max_freq - base) / N)
    return range(t0, t1 + 1)


def _angular_pair(n: int, m: int, in_size: int, out_size: int,
                  max_freq: int):
    """Angular kernel-constraint solutions for the C8 irrep pair
    (in freq n, out freq m) — R2DiscreteRotationsSolution, four cases.

    Returns a list of (sampler, mu) where sampler(angles (P,)) gives
    (out_size, in_size, P); mu is the element's angular frequency.
    """
    sols = []
    if in_size == 2 and out_size == 2:
        for gamma in (0.0, np.pi / 2):
            for s in (0, 1):
                k = m - n * (-1) ** s
                sgn = -1.0 if s > 0 else 1.0
                for t in _offsets(k, max_freq):
                    mu = k + t * N

                    def f(a, mu=mu, gamma=gamma, sgn=sgn):
                        x = mu * a + gamma
                        c, si = np.cos(x), np.sin(x)
                        return np.stack(
                            [np.stack([c, -sgn * si]),
                             np.stack([si, sgn * c])])

                    sols.append((f, mu))
    elif in_size == 2 and out_size == 1:
        for gamma in (0.0, np.pi / 2):
            k = n + m
            for t in _offsets(k, max_freq):
                mu = k + t * N

                def f(a, mu=mu, gamma=gamma):
                    x = mu * a + gamma
                    return np.stack([np.stack([np.cos(x), np.sin(x)])])

                sols.append((f, mu))
    elif in_size == 1 and out_size == 2:
        for gamma in (0.0, np.pi / 2):
            k = n + m
            for t in _offsets(k, max_freq):
                mu = k + t * N

                def f(a, mu=mu, gamma=gamma):
                    x = mu * a + gamma
                    return np.stack([np.stack([np.cos(x)]),
                                     np.stack([np.sin(x)])])

                sols.append((f, mu))
    else:
        for gamma in (0.0, np.pi / 2):
            k = m - n
            for t in _offsets(k, max_freq, non_negative=True):
                mu = k + t * N
                if mu > 0 or gamma == 0.0:
                    def f(a, mu=mu, gamma=gamma):
                        return np.stack(
                            [np.stack([np.cos(mu * a + gamma)])])

                    sols.append((f, mu))
    return sols


def _rep_irreps(kind: str):
    if kind == "regular":
        return IRREPS
    if kind == "trivial":
        return [(0, 1)]
    raise ValueError(kind)


def c8_sampled_basis(k: int, in_kind: str = "regular",
                     out_kind: str = "regular") -> np.ndarray:
    """The reference's `sampled_basis` tensor for one R2Conv block:
    (B, out_size, in_size, k*k) float64, normalized and pruned exactly
    as block_basis.py:58 SingleBlockBasisExpansion does, with basis
    elements in the reference's order (radial ring major, angular
    minor; angular ordered input-irrep-major)."""
    pts = grid_coords(k)
    radii = np.sqrt((pts ** 2).sum(0))
    angles = np.arctan2(pts[1], pts[0])
    origin = radii < 1e-9
    angles = np.where(origin, 0.0, angles)

    rings, sigmas, fco, max_freq = basis_params(k)

    in_irreps = _rep_irreps(in_kind)
    out_irreps = _rep_irreps(out_kind)
    in_size = sum(s for _, s in in_irreps)
    out_size = sum(s for _, s in out_irreps)

    Q = regular_change_of_basis()
    A_inv = Q.T if in_kind == "regular" else None
    B_cob = Q if out_kind == "regular" else None

    # --- angular direct sum (steerable_basis.py:177 _sample_direct_sum,
    #     input-irrep-major order), change of basis to the full
    #     representations, + the out-irrep size of each element
    #     (block_basis.py:88: attr["shape"][0] = out_irrep.size, used by
    #     the normalization below)
    changed = []
    in_pos = 0
    for n_f, n_s in in_irreps:
        out_pos = 0
        for m_f, m_s in out_irreps:
            for f, mu in _angular_pair(n_f, m_f, n_s, m_s, max_freq):
                blk = np.zeros((out_size, in_size, pts.shape[1]))
                samp = f(angles)
                if mu != 0:
                    samp = samp * (~origin)
                blk[out_pos:out_pos + m_s, in_pos:in_pos + n_s] = samp
                if B_cob is not None:
                    blk = np.einsum("no,oip->nip", B_cob, blk)
                if A_inv is not None:
                    blk = np.einsum("oip,ij->ojp", blk, A_inv)
                changed.append((blk, mu, m_s))
            out_pos += m_s
        in_pos += n_s

    # --- polar tensor product, ring-major with the angular basis minor
    #     (basis.py:230 PolarBasis), then the bandlimiting mask
    #     |mu| <= fco(ring). Filtering inside the ordered loop keeps the
    #     reference's masked-basis element order.
    elems, sizes = [], []
    for ring, sigma in zip(rings, sigmas):
        rad = np.exp(-0.5 * (ring - radii) ** 2 / sigma ** 2)
        for blk, mu, m_s in changed:
            if abs(mu) > fco(ring):
                continue
            elems.append(blk * rad)
            sizes.append(m_s)

    basis = np.stack(elems)  # (B, out_size, in_size, P)
    sizes = np.asarray(sizes, dtype=np.float64)

    # --- normalization (block_basis.py:12 normalize_basis)
    sq = (basis ** 2).sum(axis=(1, 2, 3))
    norms = np.sqrt(np.where(sq / sizes < 1e-15, 0.0, sq / sizes))
    norms = np.where(norms < 1e-6, 1.0, norms)
    basis = basis / norms[:, None, None, None]

    # --- prune near-zero elements (block_basis.py:105)
    keep = (basis ** 2).reshape(basis.shape[0], -1).sum(1) > 1e-2
    return basis[keep]


def expand_filter(weights: np.ndarray, k: int, out_fields: int,
                  in_fields: int, in_kind: str = "regular") -> np.ndarray:
    """Expand flat R2Conv basis coefficients to the filter tensor
    (out_fields*8, in_fields*in_size, k, k), reproducing
    block_basis.py:419 `_expand_block` for the single-io-pair case
    (all ReResNet convs: one unique input repr, one unique output repr).
    """
    basis = c8_sampled_basis(k, in_kind=in_kind, out_kind="regular")
    Bk = basis.shape[0]
    in_size = basis.shape[2]
    weights = np.asarray(weights, dtype=np.float64).reshape(-1)
    expect = out_fields * in_fields * Bk
    if weights.size != expect:
        raise ValueError(
            f"R2Conv coefficient count {weights.size} != "
            f"{out_fields}x{in_fields}x{Bk} (out_fields x in_fields x "
            f"basis dim) for kernel_size={k}, in_kind={in_kind}")
    coeff = weights.reshape(out_fields * in_fields, Bk)
    # (OF*IF, out8, inS, P)
    filt = np.einsum("cb,bois->cois", coeff, basis)
    filt = filt.reshape(out_fields, in_fields, REGULAR_SIZE, in_size,
                        k * k)
    filt = filt.transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(
        filt.reshape(out_fields * REGULAR_SIZE, in_fields * in_size, k, k)
    )
