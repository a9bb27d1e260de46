"""The GSS chain in plain PyTorch: STFT -> WPE -> cacGMM EM -> context
drop -> MVDR (Souden) + BAN -> iSTFT.

Written from the published equations (SURVEY.md section 2.9; the upstream
pb_chime5 ``core.py`` and nara_wpe / pb_bss), in float64 by default.  The
constants that define the algorithm (regularizations, floors) are the
configuration's, given by the caller.  The frequencies are independent
except for the MVDR reference channel, so WPE, the EM and the two PSDs run
in blocks of frequencies to bound the memory; the reference channel is
then picked over all of them.

``Precision('tf32')`` is the control: the same chain in complex64 with
TF32 let into the library matrix products, the step that would tempt a
later change (``torch.backends.cuda.matmul.allow_tf32``): the operands
of every product that the program leaves to cuBLAS (the WPE statistics
and filter, the final E-step, the PSDs, the beamformer) are rounded to
TF32 (10 explicit mantissa bits, round to nearest even), as tensor cores
read them.  The EM iterations' products stay in float32, as the
program's own kernel computes them.
"""

import torch

__all__ = ['Precision', 'stft', 'istft', 'wpe', 'em_posteriors',
           'mvdr_souden_ban', 'enhance']


def _round_tf32(x):
    """x rounded to TF32 (float32 with 10 mantissa bits), nearest even."""
    if x.is_complex():
        return torch.view_as_complex(
            _round_tf32(torch.view_as_real(x.resolve_conj())))
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    return ((bits + 0xFFF + keep) & ~0x1FFF).view(torch.float32)


class Precision:
    """'float64' (the reference), 'float32' (the reference in the
    program's precision, which shows how far rounding alone moves an
    utterance) or 'tf32' (the control)."""

    def __init__(self, name):
        if name not in ('float64', 'float32', 'tf32'):
            raise ValueError(name)
        self.name = name
        self.real = torch.float64 if name == 'float64' else torch.float32

    def mm(self, a, b):
        """A product the program leaves to the matrix library."""
        if self.name == 'tf32':
            a, b = _round_tf32(a), _round_tf32(b)
        return a @ b

    def tiny(self):
        return torch.finfo(self.real).tiny


def _blackman(size, dtype, device):
    n = torch.arange(size, dtype=torch.float64, device=device)
    w = (0.42 - 0.5 * torch.cos(2 * torch.pi * n / size)
         + 0.08 * torch.cos(4 * torch.pi * n / size))
    return w.to(dtype)


def stft(x, size, shift, precision):
    """(D, N) real -> (D, T, size // 2 + 1), ``size - shift`` samples of
    fading at both ends, the tail zero-padded to a whole frame."""
    x = torch.nn.functional.pad(x.to(precision.real),
                                (size - shift, size - shift))
    n = x.shape[-1]
    frames = max(1, -(-(n - size + shift) // shift))
    x = torch.nn.functional.pad(x, (0, (frames - 1) * shift + size - n))
    segments = x.unfold(-1, size, shift) * _blackman(size, x.dtype, x.device)
    return torch.fft.rfft(segments, n=size, dim=-1)


def istft(X, size, shift, num_samples):
    """(T, size // 2 + 1) -> (num_samples,) by overlap-add with the
    biorthogonal synthesis window, the fading removed."""
    window = _blackman(size, X.real.dtype, X.device)
    denom = (window ** 2).reshape(size // shift, shift).sum(0)
    synthesis = window / denom.repeat(size // shift)
    frames = torch.fft.irfft(X, n=size, dim=-1) * synthesis
    T = frames.shape[0]
    out = torch.zeros((T - 1) * shift + size, dtype=frames.dtype,
                      device=X.device)
    for j in range(size // shift):
        piece = frames[:, j * shift:(j + 1) * shift].reshape(-1)
        out[j * shift:j * shift + piece.numel()] += piece
    out = out[size - shift:out.numel() - (size - shift)]
    return torch.nn.functional.pad(out, (0, max(0, num_samples - out.numel()))
                                   )[:num_samples]


def _hermitize(A):
    return 0.5 * (A + A.conj().transpose(-2, -1))


def _solve_loaded(A, B, load, precision):
    """A X = B for Hermitian PSD A (..., d, d): A scaled to unit diagonal,
    ``load`` added on that diagonal, Cholesky, scaling undone."""
    d = A.shape[-1]
    diag = torch.diagonal(A, dim1=-2, dim2=-1).real
    maxdiag = diag.amax(dim=-1, keepdim=True)
    eps = torch.finfo(precision.real).eps
    floor = torch.where(maxdiag > 0, maxdiag * eps, torch.ones_like(maxdiag))
    s = torch.sqrt(torch.maximum(diag, floor))
    sinv = (1.0 / s).to(A.dtype)
    As = _hermitize(A * sinv[..., :, None] * sinv[..., None, :]) \
        + load * torch.eye(d, dtype=A.dtype, device=A.device)
    L = torch.linalg.cholesky(As)
    return sinv[..., :, None] * torch.cholesky_solve(sinv[..., :, None] * B, L)


def wpe(Y, taps, delay, iterations, load, precision):
    """Offline WPE of Y (F, D, T): statistics weighted by the inverse power
    (the mean over channels, floored at 1e-10 of its largest frame), the
    filter from the loaded solve, X = Y - G^H Y~."""
    F, D, T = Y.shape
    parts = []
    for tau in range(taps):
        shift = delay + tau
        part = torch.zeros_like(Y)
        if shift < T:
            part[..., shift:] = Y[..., :T - shift]
        parts.append(part)
    Yt = torch.cat(parts, dim=1)                            # (F, taps D, T)
    X = Y
    for _ in range(iterations):
        power = (X.real ** 2 + X.imag ** 2).mean(dim=1)     # (F, T)
        floor = torch.clamp_min(1e-10 * power.amax(dim=-1, keepdim=True),
                                precision.tiny())
        inverse = 1.0 / torch.maximum(power, floor)
        weighted = Yt * inverse[:, None, :].to(Yt.dtype)
        R = _hermitize(precision.mm(weighted, Yt.conj().transpose(-2, -1)))
        P = precision.mm(weighted, Y.conj().transpose(-2, -1))
        G = _solve_loaded(R, P, load, precision)
        X = Y - precision.mm(G.conj().transpose(-2, -1), Yt)
    return X


def _finalize(S, den, diagonal_floor, precision):
    """M-step parameters from the scatter S (F, K, D, D) = sum_t gamma/q z
    z^H and the masses den (F, K): log mixture weights, precisions and
    log-determinants of the trace-normalized, loaded covariances."""
    F, K, D, _ = S.shape
    tiny = precision.tiny()
    total = den.sum(dim=-1, keepdim=True)
    weight = torch.where(total > 0, den / torch.clamp_min(total, tiny),
                         torch.zeros_like(den))
    log_weight = torch.log(torch.clamp_min(weight, tiny))
    cov = _hermitize(S * (D / torch.clamp_min(
        den, 2.0 * D / torch.finfo(den.dtype).max))[..., None, None])
    trace = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1).real / D
    eye = torch.eye(D, dtype=cov.dtype, device=cov.device)
    zero = trace <= tiny
    cov = torch.where(zero[..., None, None], eye,
                      cov / torch.where(zero, torch.ones_like(trace),
                                        trace)[..., None, None])
    cov = cov + diagonal_floor * eye
    L = torch.linalg.cholesky(cov)
    logdet = 2 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1).real).sum(-1)
    return log_weight, torch.cholesky_inverse(L), logdet


def _quadratic_form(z, precision_matrices, mm):
    """Re z_t^H P_k z_t: z (F, T, D), P (F, K, D, D) -> (F, K, T)."""
    Pz = mm(precision_matrices, z.transpose(-2, -1)[:, None])
    return (Pz * z.transpose(-2, -1).conj()[:, None]).real.sum(dim=-2)


def _e_step(z, params, gate, precision, mm=torch.matmul):
    """Class posteriors (F, K, T) and quadratic forms: the log-pdf shifted
    by its largest class, then gated by the activity and normalized."""
    log_weight, P, logdet = params
    D = z.shape[-1]
    tiny = precision.tiny()
    q = torch.clamp_min(_quadratic_form(z, P, mm), tiny)
    log_pdf = log_weight[..., None] - D * torch.log(q) - logdet[..., None]
    gamma = torch.exp(log_pdf - log_pdf.amax(dim=1, keepdim=True))
    if gate is not None:
        gamma = gamma * gate
    return gamma / torch.clamp_min(gamma.sum(dim=1, keepdim=True), tiny), q


def _scatter(z, coeff):
    """sum_t coeff_kt z_t z_t^H: (F, T, D), (F, K, T) -> (F, K, D, D)."""
    weighted = z.transpose(-2, -1)[:, None] * coeff[:, :, None, :].to(z.dtype)
    return weighted @ z.conj()[:, None]


def em_posteriors(Y, activity, iterations, iterations_post, init_floor,
                  diagonal_floor, precision):
    """cacGMM posteriors (F, K, T) of Y (F, D, T) under the class activity
    (K, T): one M-step from the floored, normalized activity, then
    ``iterations - 1`` passes with the posteriors gated by the activity,
    ``iterations_post - 1`` ungated ones, and a final ungated E-step."""
    y = Y.transpose(-2, -1)                                  # (F, T, D)
    norm = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    tiny = precision.tiny()
    z = torch.where(norm > tiny, y / torch.clamp_min(norm, tiny),
                    torch.zeros((), dtype=y.dtype, device=y.device))
    gate = activity.to(precision.real)
    init = torch.where(gate == 0, torch.full_like(gate, init_floor), gate)
    init = init / init.sum(dim=0, keepdim=True)
    gamma = init.expand(z.shape[0], -1, -1)
    params = _finalize(_scatter(z, gamma), gamma.sum(-1),
                       diagonal_floor, precision)
    for step in range(iterations - 1 + max(iterations_post - 1, 0)):
        gamma, q = _e_step(z, params, gate if step < iterations - 1 else None,
                           precision)
        params = _finalize(_scatter(z, gamma / q), gamma.sum(-1),
                           diagonal_floor, precision)
    return _e_step(z, params, gate if iterations_post == 0 else None,
                   precision, precision.mm)[0]


def _psd(Y, mask, precision):
    """sum_t m_ft y_ft y_ft^H / sum_t m_ft: (F, D, T), (F, T) -> (F, D, D)."""
    weighted = Y * mask[:, None, :].to(Y.dtype)
    norm = torch.clamp_min(mask.sum(dim=-1), precision.tiny())
    return precision.mm(weighted, Y.conj().transpose(-2, -1)) \
        / norm[:, None, None].to(Y.dtype)


def mvdr_souden_ban(Y, cov_x, cov_n, load, eps, precision):
    """MVDR in Souden's form with the reference channel of the largest
    frequency-summed output SNR, BAN, applied to Y (F, D, T) -> (F, T)."""
    D = Y.shape[1]
    phi = _solve_loaded(cov_n, cov_x, load, precision)
    trace = torch.diagonal(phi, dim1=-2, dim2=-1).sum(-1).real
    mat = phi / torch.clamp_min(trace, eps)[:, None, None].to(phi.dtype)
    num = torch.einsum('fdr,fde,fer->r', mat.conj(), cov_x, mat).real
    den = torch.einsum('fdr,fde,fer->r', mat.conj(), cov_n, mat).real
    ref = int(torch.argmax(num / torch.clamp_min(den, eps)))
    w = mat[:, :, ref]
    nw = torch.einsum('fde,fe->fd', cov_n, w)
    gain = torch.sqrt(torch.abs(torch.einsum(
        'fd,fd->f', w.conj(), torch.einsum('fde,fe->fd', cov_n, nw)) / D)) \
        / torch.clamp_min(torch.abs(torch.einsum('fd,fd->f', w.conj(), nw)),
                          precision.tiny())
    w = w * gain[:, None].to(w.dtype)
    return precision.mm(w.conj()[:, None, :], Y)[:, 0]


def enhance(obs, activity, target, context_frames, params, precision, *,
            block=64):
    """One utterance: obs (D, N) real on the compute device (PCM already
    scaled), activity (K, T) bool, the target class, (start, end) context
    frames -> the enhanced (N,) waveform.  ``params``: stft_size,
    stft_shift, wpe_taps, wpe_delay, wpe_iterations, wpe_load,
    bss_iterations, bss_iterations_post, em_init_floor, em_diagonal_floor,
    mvdr_load, mvdr_eps."""
    p = params
    size, shift = p['stft_size'], p['stft_shift']
    Obs = stft(obs, size, shift, precision).permute(2, 0, 1).contiguous()
    F, D, T = Obs.shape
    gate = torch.as_tensor(activity[:, :T], device=obs.device)
    start_cf, end_cf = context_frames
    frames = torch.arange(T, device=obs.device)
    keep = ((frames >= start_cf) & (frames < T - end_cf)).to(precision.real)
    X = torch.empty_like(Obs)
    cov_x = torch.empty((F, D, D), dtype=Obs.dtype, device=obs.device)
    cov_n = torch.empty_like(cov_x)
    for lo in range(0, F, block):
        f = slice(lo, min(lo + block, F))
        X[f] = wpe(Obs[f], p['wpe_taps'], p['wpe_delay'], p['wpe_iterations'],
                   p['wpe_load'], precision)
        masks = em_posteriors(
            X[f], gate, p['bss_iterations'], p['bss_iterations_post'],
            p['em_init_floor'], p['em_diagonal_floor'], precision) * keep
        target_mask = masks[:, target]
        cov_x[f] = _psd(X[f], target_mask, precision)
        cov_n[f] = _psd(X[f], masks.sum(dim=1) - target_mask, precision)
    X_hat = mvdr_souden_ban(X, cov_x, cov_n, p['mvdr_load'], p['mvdr_eps'],
                            precision)
    return istft(X_hat.T, size, shift, obs.shape[-1])
