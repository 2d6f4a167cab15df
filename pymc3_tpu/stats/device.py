"""On-device convergence diagnostics.

Batched jnp implementations of split R-hat and bulk ESS that run on the
device over the raw ``(chains, draws, dim)`` sample block — for the 10k-chain
regime the host round-trip of ``pymc3_tpu.stats`` (numpy, per-element loop)
dominates; these compute every parameter at once on the device and can run
*inside* a sharded program with a ``psum`` over the chain mesh axis
(SURVEY §5: on-device R-hat/ESS as collectives).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["rhat_device", "ess_device", "rhat_split", "ess_bulk"]


def _split(x):
    """(chains, draws, dim) -> (2*chains, draws//2, dim)."""
    c, n = x.shape[0], x.shape[1]
    half = n // 2
    return jnp.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)


def rhat_split(x):
    """Split R-hat per parameter; x is (chains, draws, dim) -> (dim,).

    Plain (non rank-normalized) split R-hat — the variant that vectorizes
    exactly on device; the host path provides the rank-normalized version.
    """
    x = _split(jnp.asarray(x))
    m, n = x.shape[0], x.shape[1]
    chain_mean = jnp.mean(x, axis=1)                      # (m, dim)
    chain_var = jnp.var(x, axis=1, ddof=1)                # (m, dim)
    between = n * jnp.var(chain_mean, axis=0, ddof=1)     # (dim,)
    within = jnp.mean(chain_var, axis=0)                  # (dim,)
    vhat = (n - 1.0) / n * within + between / n
    return jnp.sqrt(vhat / within)


def _autocov_fft(x, n):
    """Per-chain autocovariance via rFFT; x (m, n, dim) -> (m, n, dim)."""
    mpad = 2 ** int(np.ceil(np.log2(2 * n)))
    centered = x - jnp.mean(x, axis=1, keepdims=True)
    f = jnp.fft.rfft(centered, mpad, axis=1)
    acov = jnp.fft.irfft(f * jnp.conj(f), mpad, axis=1)[:, :n].real
    return acov / n


def ess_bulk(x):
    """Bulk ESS per parameter; x is (chains, draws, dim) -> (dim,).

    Uses Geyer's initial positive sequence with a vectorized monotone
    truncation (the pairwise-sum positivity rule applied via a running
    cumulative minimum — matches the host implementation to a few percent).
    """
    x = _split(jnp.asarray(x, jnp.float32))
    m, n, dim = x.shape
    acov = _autocov_fft(x, n)
    chain_mean = jnp.mean(x, axis=1)
    mean_var = jnp.mean(acov[:, 0], axis=0) * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    var_plus = var_plus + jnp.var(chain_mean, axis=0, ddof=1)

    rho = 1.0 - (mean_var[None] - jnp.mean(acov, axis=0)) / var_plus[None]
    rho = rho.at[0].set(1.0)                                  # (n, dim)

    # Geyer: pair consecutive lags (even,odd); keep pairs while the pair sum
    # stays positive; enforce monotone decrease with a cumulative min.
    n_pairs = n // 2
    pair = rho[: 2 * n_pairs].reshape(n_pairs, 2, dim).sum(axis=1)
    pos = pair > 0
    keep = jnp.cumprod(pos, axis=0).astype(bool)
    # monotone decrease over the KEPT prefix (inf placeholders never lower
    # the running min), truncated tail contributes exactly zero
    mono = jax.lax.associative_scan(
        jnp.minimum, jnp.where(keep, pair, jnp.inf), axis=0)
    pair = jnp.where(keep, mono, 0.0)
    tau = -1.0 + 2.0 * jnp.sum(pair, axis=0)
    tau = jnp.maximum(tau, 1.0)
    return (m * n) / tau


@jax.jit
def _diag_all(x):
    return rhat_split(x), ess_bulk(x)


def rhat_device(samples) -> np.ndarray:
    """Host-facing wrapper: (chains, draws, ...) -> per-element R-hat."""
    x = np.asarray(samples)
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    r, _ = _diag_all(jnp.asarray(flat))
    return np.asarray(r).reshape(x.shape[2:] or ())


def ess_device(samples) -> np.ndarray:
    x = np.asarray(samples)
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    _, e = _diag_all(jnp.asarray(flat))
    return np.asarray(e).reshape(x.shape[2:] or ())
