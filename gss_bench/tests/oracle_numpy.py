"""A plain-NumPy oracle of the chain's equations, for the tests of the
benchmark's reference: a frozen copy of the repository's
``tests/reference_numpy.py``, rewritten to state the same constants as
the configurations (the loaded, equilibrated solves of WPE and the MVDR
beamformer, the EM's trace-normalized covariances with a diagonal load).

Written from the published equations (SURVEY.md section 2.9), apart from
``gss_bench/reference``: explicit loops over frequencies, eigendecompo-
sitions and ``np.linalg.solve`` where the reference batches, Cholesky
factors and PyTorch.  Everything is float64 / complex128.
"""

import numpy as np

TINY = np.finfo(np.float64).tiny


# ---------------------------------------------------------------- STFT ----

def blackman_periodic(size):
    n = np.arange(size)
    return (0.42 - 0.5 * np.cos(2 * np.pi * n / size)
            + 0.08 * np.cos(4 * np.pi * n / size))


def stft_np(x, size, shift):
    """(..., N) -> (..., T, size // 2 + 1), faded at both ends, the tail
    padded to a whole frame."""
    x = np.asarray(x, dtype=np.float64)
    window = blackman_periodic(size)
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(size - shift,) * 2])
    n = x.shape[-1]
    frames = max(1, int(np.ceil((n - size + shift) / shift)))
    full = (frames - 1) * shift + size
    if full > n:
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, full - n)])
    out = np.empty((*x.shape[:-1], frames, size // 2 + 1),
                   dtype=np.complex128)
    for t in range(frames):
        seg = x[..., t * shift:t * shift + size] * window
        out[..., t, :] = np.fft.rfft(seg, n=size, axis=-1)
    return out


def istft_np(X, size, shift):
    """(..., T, size // 2 + 1) -> (..., (T - 1) shift + size - 2 (size -
    shift)) by overlap-add with the biorthogonal synthesis window."""
    window = blackman_periodic(size)
    denom = (window ** 2).reshape(-1, shift).sum(0)
    syn = window / np.tile(denom, size // shift)
    T = X.shape[-2]
    out = np.zeros((*X.shape[:-2], (T - 1) * shift + size))
    for t in range(T):
        out[..., t * shift:t * shift + size] += (
            np.fft.irfft(X[..., t, :], n=size) * syn)
    return out[..., size - shift:out.shape[-1] - (size - shift)]


# ------------------------------------------------------------- solves ----

def loaded_solve(A, B, load):
    """A X = B with A scaled to unit diagonal and ``load`` added there."""
    s = np.sqrt(np.maximum(np.diag(A).real,
                           np.diag(A).real.max() * np.finfo(float).eps))
    As = A / np.outer(s, s) + load * np.eye(A.shape[0])
    return np.linalg.solve(As, B / s[:, None]) / s[:, None]


# ----------------------------------------------------------------- WPE ----

def wpe_np(Y, taps, delay, iterations, load):
    """Y (F, D, T) complex128 -> (F, D, T)."""
    F, D, T = Y.shape
    X = Y.copy()
    for _ in range(iterations):
        power = np.mean(np.abs(X) ** 2, axis=1)             # (F, T)
        floor = 1e-10 * power.max(axis=-1, keepdims=True)
        inv_power = 1.0 / np.maximum(power, floor)
        X = np.empty_like(Y)
        for f in range(F):
            Yt = np.zeros((taps * D, T), dtype=Y.dtype)
            for tau in range(taps):
                shiftn = delay + tau
                Yt[tau * D:(tau + 1) * D, shiftn:] = Y[f, :, :T - shiftn]
            R = (Yt * inv_power[f]) @ Yt.conj().T
            P = (Yt * inv_power[f]) @ Y[f].conj().T
            G = loaded_solve((R + R.conj().T) / 2, P, load)
            X[f] = Y[f] - G.conj().T @ Yt
    return X


# -------------------------------------------------------------- cacGMM ----

def cacgmm_posteriors_np(Y, activity, iterations, iterations_post,
                         init_floor, diagonal_floor):
    """Y (F, T, D) complex128, activity (K, T) -> posteriors (F, K, T)."""
    F, T, D = Y.shape
    K = activity.shape[0]
    init = np.asarray(activity, dtype=np.float64)
    init = np.where(init == 0, init_floor, init)
    init = init / init.sum(axis=0, keepdims=True)
    mask = np.asarray(activity, dtype=bool)

    out = np.empty((F, K, T))
    for f in range(F):
        y = Y[f]
        z = y / np.maximum(np.linalg.norm(y, axis=-1, keepdims=True), TINY)

        def m_step(gamma, q):
            denom = gamma.sum(axis=-1)                      # (K,)
            weight = denom / max(denom.sum(), TINY)
            precisions = np.empty((K, D, D), dtype=np.complex128)
            logdets = np.empty(K)
            for k in range(K):
                coeff = gamma[k] / np.maximum(q[k], TINY)
                B = D * (z * coeff[:, None]).T @ z.conj() / max(denom[k],
                                                                TINY)
                B = (B + B.conj().T) / 2
                # trace-normalized; a class with no mass: the identity
                trace = np.trace(B).real / D
                B = B / trace if trace > TINY else np.eye(D)
                B = B + diagonal_floor * np.eye(D)
                ew, ev = np.linalg.eigh(B)
                precisions[k] = (ev / ew) @ ev.conj().T
                logdets[k] = np.log(ew).sum()
            return np.log(np.maximum(weight, TINY)), precisions, logdets

        def e_step(params, with_mask):
            logw, precisions, logdets = params
            q = np.empty((K, T))
            for k in range(K):
                q[k] = np.einsum('td,de,te->t', z.conj(), precisions[k],
                                 z).real
            q = np.maximum(q, TINY)
            ll = logw[:, None] - D * np.log(q) - logdets[:, None]
            g = np.exp(ll - ll.max(axis=0, keepdims=True))
            if with_mask:
                g = g * mask
            return g / np.maximum(g.sum(axis=0, keepdims=True), TINY), q

        params = m_step(init, np.ones((K, T)))
        for _ in range(iterations - 1):
            params = m_step(*e_step(params, True))
        if iterations_post == 0:
            gamma, _ = e_step(params, True)
        else:
            for _ in range(iterations_post - 1):
                params = m_step(*e_step(params, False))
            gamma, _ = e_step(params, False)
        out[f] = gamma
    return out


# ---------------------------------------------------------- beamformer ----

def psd_np(Y, mask):
    """Y (F, D, T), mask (F, T) -> (F, D, D)."""
    F, D, T = Y.shape
    out = np.empty((F, D, D), dtype=np.complex128)
    for f in range(F):
        out[f] = (Y[f] * mask[f]) @ Y[f].conj().T / max(mask[f].sum(), TINY)
    return out


def mvdr_souden_np(cov_x, cov_n, load, eps):
    """Souden's MVDR with the reference channel of the largest
    frequency-summed output SNR -> ((F, D) weights, reference)."""
    F, D, _ = cov_x.shape
    mat = np.empty_like(cov_x)
    for f in range(F):
        phi = loaded_solve(cov_n[f], cov_x[f], load)
        mat[f] = phi / max(np.trace(phi).real, eps)
    num = np.einsum('fdr,fde,fer->r', mat.conj(), cov_x, mat).real
    den = np.einsum('fdr,fde,fer->r', mat.conj(), cov_n, mat).real
    ref = int(np.argmax(num / np.maximum(den, eps)))
    return mat[..., ref], ref


def ban_np(w, cov_n):
    D = w.shape[-1]
    out = np.empty_like(w)
    for f in range(w.shape[0]):
        nw = cov_n[f] @ w[f]
        num = np.sqrt(abs(w[f].conj() @ cov_n[f] @ nw / D))
        out[f] = w[f] * num / max(abs(w[f].conj() @ nw), TINY)
    return out


def enhance_np(obs, activity, target, context_frames, p):
    """One utterance through the chain: obs (D, N) float64, activity
    (K, >= T) -> the enhanced (N,) waveform."""
    size, shift = p['stft_size'], p['stft_shift']
    Y = stft_np(obs, size, shift).transpose(2, 0, 1)        # (F, D, T)
    F, D, T = Y.shape
    X = wpe_np(Y, p['wpe_taps'], p['wpe_delay'], p['wpe_iterations'],
               p['wpe_load'])
    masks = cacgmm_posteriors_np(
        X.transpose(0, 2, 1), activity[:, :T], p['bss_iterations'],
        p['bss_iterations_post'], p['em_init_floor'], p['em_diagonal_floor'])
    frames = np.arange(T)
    keep = (frames >= context_frames[0]) & (frames < T - context_frames[1])
    masks = masks * keep
    target_mask = masks[:, target]
    cov_x = psd_np(X, target_mask)
    cov_n = psd_np(X, masks.sum(axis=1) - target_mask)
    w, _ = mvdr_souden_np(cov_x, cov_n, p['mvdr_load'], p['mvdr_eps'])
    w = ban_np(w, cov_n)
    X_hat = np.einsum('fd,fdt->ft', w.conj(), X)
    out = istft_np(X_hat.T, size, shift)
    return np.pad(out, (0, max(0, obs.shape[-1] - out.shape[-1])))[
        :obs.shape[-1]]
