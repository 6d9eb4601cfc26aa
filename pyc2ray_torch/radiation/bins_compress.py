"""Sum-of-exponentials compression of spectral bins.

The spectral-bin rate pass (spectral_bins.py) evaluates, per cell and
per bin, exp(-tau_in s_e) * (-expm1(-dtau s_e)) — the pass is
dominated by transcendental evaluations, so its cost is directly
proportional to the bin count E. But the *functions* the bins represent,

    F(tau) = sum_e w_e exp(-s_e tau)          (band transmission)
    G(tau) = sum_e w_e s_e exp(-s_e tau)      (= -F', the "thin" rate)

are completely monotone exponential sums over a ~4-decade range of decay
rates s — a class famously compressible: a much shorter exponential sum
reproduces them to near machine precision. Replacing (s_e, w_e) by a
compressed (s_k, w_k) is a pure drop-in: every consumer keeps the exact
same cancellation-free per-bin form, only with fewer bins.

Accuracy argument: the per-cell absorbed fraction is the *difference*
D = F(tau_in) - F(tau_out) = integral of G over [tau_in, tau_out].
The compressed model's difference D~ = integral of G~, so
|D - D~| <= int |G - G~| <= eps * int G = eps * D whenever G~ has
pointwise RELATIVE error <= eps. Uniform relative accuracy of G (and of
F, for the tau_in = 0 cells) is therefore the right fit criterion — it
bounds the error of every rate the engine can produce, with no
cancellation amplification (the compressed sum is evaluated with the
same expm1 form, exactly as an exponential sum of its own).

Fit method: greedy backward elimination over shared nodes with
non-negative least squares for the per-channel weights (photo + heat
share nodes so both channels stay a single fused pass). Non-negativity
keeps every compressed bin a physical "frequency bin" (positive photon
weight), so rates can never go negative. Runs once at engine init in
float64 on the host.
"""

import numpy as np

from .spectral_bins import SpectralBins

__all__ = ["compress_bins", "compression_error"]


def _eval_FG(s, w, tau):
    """F and G = -F' of an exponential sum at tau (vectorized, f64)."""
    E = np.exp(-np.outer(tau, s))
    return E @ w, E @ (w * s)


def _rel_errors(s_ref, wp_ref, wh_ref, s, wp, wh, tau):
    """Max relative error of (F, G) for both channels on a tau grid."""
    errs = []
    for w_ref, w in ((wp_ref, wp), (wh_ref, wh)):
        F0, G0 = _eval_FG(s_ref, w_ref, tau)
        F1, G1 = _eval_FG(s, w, tau)
        # floor: relative where the function is non-negligible compared
        # to its peak; deep-underflow tails carry no physical rate.
        fF = np.maximum(np.abs(F0), 1e-12 * np.max(F0))
        fG = np.maximum(np.abs(G0), 1e-12 * np.max(G0))
        errs.append(np.max(np.abs(F1 - F0) / fF))
        errs.append(np.max(np.abs(G1 - G0) / fG))
    return max(errs)


def _fit_weights(s_ref, w_ref, s_nodes, tau, w0_boost=100.0):
    """Non-negative least-squares weights for one channel on given nodes.

    Rows: F and G at each tau, scaled to relative error; the tau=0 row of
    F (total photon normalization — the photon budget) is boosted so the
    compressed sum conserves the band-integrated rate to ~eps/boost.
    """
    from scipy.optimize import nnls
    F0, G0 = _eval_FG(s_ref, w_ref, tau)
    fF = np.maximum(np.abs(F0), 1e-12 * np.max(F0))
    fG = np.maximum(np.abs(G0), 1e-12 * np.max(G0))
    EF = np.exp(-np.outer(tau, s_nodes))
    EG = EF * s_nodes[None, :]
    boost = np.ones_like(tau)
    boost[tau == 0.0] = w0_boost
    A = np.vstack([EF / fF[:, None] * boost[:, None],
                   EG / fG[:, None]])
    b = np.concatenate([F0 / fF * boost, G0 / fG])
    try:
        w, _ = nnls(A, b, maxiter=200 * A.shape[1])
    except RuntimeError:
        # NNLS can cycle on ill-conditioned exponential design matrices;
        # fall back to a tiny-ridge bounded lsq (still non-negative)
        from scipy.optimize import lsq_linear
        res = lsq_linear(A, b, bounds=(0.0, np.inf),
                         lsmr_tol="auto", max_iter=500)
        w = np.maximum(res.x, 0.0)
    return w


def _cache_path(bins, target_rel, tau_max):
    import hashlib
    import os
    h = hashlib.sha256()
    for a in (bins.s, bins.w_photo, bins.w_heat):
        h.update(np.ascontiguousarray(np.asarray(a, np.float64)).tobytes())
    h.update(np.float64(target_rel).tobytes())
    h.update(np.float64(tau_max).tobytes())
    base = os.environ.get(
        "PYC2RAY_TORCH_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "pyc2ray_torch"))
    return os.path.join(base, "bins", h.hexdigest()[:24] + ".npz")


def compress_bins(bins: SpectralBins, target_rel=1e-4, tau_max=1e5,
                  n_tau=200, cache=True):
    """Compress a SpectralBins to the fewest shared nodes meeting
    ``target_rel`` uniform relative error on (F, G) of both channels.

    Returns a new SpectralBins (same NamedTuple contract). The input is
    returned unchanged if it is already at or below the achievable
    minimum (e.g. grey single-bin sources). The fit (seconds of host
    scipy) is cached on disk keyed by the input bins + target, so any
    repeated configuration is a file read."""
    E = bins.num_bins
    if E <= 2:
        return bins
    s_all = np.asarray(bins.s, np.float64)
    if np.ptp(s_all) <= 1e-12 * np.abs(s_all).max():
        # grey source: every bin decays at the same rate — the exact
        # compression is a single node (enables the analytic grey path)
        return SpectralBins(
            s=s_all[:1].copy(),
            w_photo=np.array([np.sum(bins.w_photo)]),
            w_heat=np.array([np.sum(bins.w_heat)]), num_bins=1)
    cpath = _cache_path(bins, target_rel, tau_max) if cache else None
    if cpath is not None:
        try:
            with np.load(cpath) as z:
                return SpectralBins(s=z["s"], w_photo=z["wp"],
                                    w_heat=z["wh"], num_bins=len(z["s"]))
        except (OSError, KeyError):
            pass
    s_ref = np.asarray(bins.s, np.float64)
    wp_ref = np.asarray(bins.w_photo, np.float64)
    wh_ref = np.asarray(bins.w_heat, np.float64)
    # fit grid: tau = 0 plus log-spaced; validation grid is denser and
    # offset so the fit cannot overfit the grid points
    tau = np.concatenate([[0.0], np.geomspace(1e-8, tau_max, n_tau)])
    tau_val = np.concatenate([[0.0],
                              np.geomspace(1.7e-8, tau_max, 3 * n_tau)])

    def err_for(node_set):
        wp_t = _fit_weights(s_ref, wp_ref, node_set, tau)
        wh_t = _fit_weights(s_ref, wh_ref, node_set, tau)
        return (_rel_errors(s_ref, wp_ref, wh_ref, node_set, wp_t, wh_t,
                            tau_val), wp_t, wh_t)

    def fit_K(K):
        """Variable projection: optimize K log-node positions, with the
        per-channel weights eliminated by inner NNLS at every step."""
        from scipy.optimize import least_squares
        F0p, G0p = _eval_FG(s_ref, wp_ref, tau)
        F0h, G0h = _eval_FG(s_ref, wh_ref, tau)
        scales = [np.maximum(np.abs(v), 1e-12 * np.max(v))
                  for v in (F0p, G0p, F0h, G0h)]

        def resid(x):
            nd = np.exp(x)
            wp_t = _fit_weights(s_ref, wp_ref, nd, tau)
            wh_t = _fit_weights(s_ref, wh_ref, nd, tau)
            F1p, G1p = _eval_FG(nd, wp_t, tau)
            F1h, G1h = _eval_FG(nd, wh_t, tau)
            return np.concatenate([
                (F1p - F0p) / scales[0], (G1p - G0p) / scales[1],
                (F1h - F0h) / scales[2], (G1h - G0h) / scales[3]])

        lo, hi = np.log(s_ref.min()) - 2.0, np.log(s_ref.max()) + 2.0
        x0 = np.log(np.geomspace(s_ref.min(), s_ref.max(), K))
        res = least_squares(resid, x0, method="trf", max_nfev=40 * K,
                            diff_step=1e-4, bounds=(lo, hi))
        nd = np.sort(np.exp(res.x))
        e, wp_t, wh_t = err_for(nd)
        return e, nd, wp_t, wh_t

    best = None
    for K in range(4, min(E, 28) + 1, 2):
        e, nd, wp, wh = fit_K(K)
        if e <= target_rel:
            best = (nd, wp, wh)
            break
    if best is None:
        # could not meet the target with fewer nodes than the input —
        # return the input unchanged rather than a degraded model
        return bins
    nodes, wp, wh = best
    keep = (wp > 0) | (wh > 0)
    nodes, wp, wh = nodes[keep], wp[keep], wh[keep]
    out = SpectralBins(s=nodes, w_photo=wp, w_heat=wh,
                       num_bins=len(nodes))
    if cpath is not None:
        try:
            import os
            os.makedirs(os.path.dirname(cpath), exist_ok=True)
            np.savez(cpath, s=nodes, wp=wp, wh=wh)
        except OSError:
            pass
    return out


def compression_error(bins_ref: SpectralBins, bins_cmp: SpectralBins,
                      tau_max=1e5, n_tau=600):
    """Max relative (F, G) error of a compressed bin set vs a reference
    (validation helper; used by tests and the accuracy study)."""
    tau = np.concatenate([[0.0], np.geomspace(1e-8, tau_max, n_tau)])
    return _rel_errors(np.asarray(bins_ref.s, np.float64),
                       np.asarray(bins_ref.w_photo, np.float64),
                       np.asarray(bins_ref.w_heat, np.float64),
                       np.asarray(bins_cmp.s, np.float64),
                       np.asarray(bins_cmp.w_photo, np.float64),
                       np.asarray(bins_cmp.w_heat, np.float64), tau)
