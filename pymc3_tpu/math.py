"""Node-aware math library, mirroring the reference ``pymc3/math.py``.

Every function accepts symbolic :class:`~pymc3_tpu.node.Node` operands or
concrete arrays and returns a node (or concrete result when all inputs are
concrete). The reference exposed Theano ops plus custom Ops (``LogDet``
``math.py:174``, ``BatchedDiag:263``, ``BlockDiagonalMatrix:311``, Kronecker
algebra ``math.py:39-118``); here each is a plain jnp function — XLA fuses the
elementwise chains and hands the linear algebra to the device's libraries.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
import jax.scipy.special as jss
from jax import lax

from .node import apply, Node

__all__ = [
    "abs_", "exp", "log", "log1p", "log2", "log10", "sqrt", "sgn", "sqr",
    "ceil", "floor", "round_", "erf", "erfc", "erfinv", "erfcinv",
    "sin", "cos", "tan", "sinh", "cosh", "tanh", "arcsin", "arccos",
    "arctan", "arctan2", "arcsinh", "arccosh", "arctanh",
    "dot", "matmul", "outer", "maximum", "minimum", "where", "switch",
    "clip", "stack", "concatenate", "sum", "prod", "mean", "cumsum",
    "cumprod", "flatten", "ones_like", "zeros_like", "full_like", "eye",
    "diag", "extract_diag", "tril", "triu", "constant", "sigmoid", "softmax",
    "log_softmax", "logsumexp", "logaddexp", "logdiffexp", "logit",
    "invlogit", "probit", "invprobit", "expand_packed_triangular",
    "log1pexp", "log1mexp", "log1mexp_numpy", "flat_outer",
    "kronecker", "cartesian", "kron_matrix_op", "kron_dot", "kron_solve_lower",
    "kron_solve_upper", "kron_diag", "flatten_list", "logdet", "batched_diag",
    "block_diagonal", "cholesky", "solve", "solve_lower", "solve_upper",
    "matrix_inverse", "tround", "floatX_array", "largest_common_dtype",
]


def _wrap(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return apply(lambda *a: fn(*a, **kwargs), *args)
    return wrapped


# -- elementwise ------------------------------------------------------------
abs_ = _wrap(jnp.abs)
exp = _wrap(jnp.exp)
log = _wrap(jnp.log)
log1p = _wrap(jnp.log1p)
log2 = _wrap(jnp.log2)
log10 = _wrap(jnp.log10)
sqrt = _wrap(jnp.sqrt)
sgn = _wrap(jnp.sign)
ceil = _wrap(jnp.ceil)
floor = _wrap(jnp.floor)
round_ = _wrap(jnp.round)
tround = round_
erf = _wrap(jss.erf)
erfc = _wrap(jss.erfc)
erfinv = _wrap(jss.erfinv)
sin = _wrap(jnp.sin)
cos = _wrap(jnp.cos)
tan = _wrap(jnp.tan)
sinh = _wrap(jnp.sinh)
cosh = _wrap(jnp.cosh)
tanh = _wrap(jnp.tanh)
arcsin = _wrap(jnp.arcsin)
arccos = _wrap(jnp.arccos)
arctan = _wrap(jnp.arctan)
arctan2 = _wrap(jnp.arctan2)
arcsinh = _wrap(jnp.arcsinh)
arccosh = _wrap(jnp.arccosh)
arctanh = _wrap(jnp.arctanh)
maximum = _wrap(jnp.maximum)
minimum = _wrap(jnp.minimum)
sigmoid = _wrap(jss.expit)
logit = _wrap(jss.logit)
invlogit_ = _wrap(jss.expit)


def sqr(x):
    return apply(jnp.square, x)


def erfcinv(x):
    return apply(lambda v: jss.erfinv(1.0 - v), x)


def invlogit(x, eps=None):
    """Inverse logit; optional eps shrinks output into (eps, 1-eps).

    cf. ``pymc3/math.py:146`` (eps default sys.float_info.epsilon there; we
    default to exact sigmoid, passing eps reproduces the clamped version).
    """
    if eps is None:
        return apply(jss.expit, x)
    return apply(lambda v: (1.0 - 2.0 * eps) * jss.expit(v) + eps, x)


def probit(p):
    """Inverse of standard-normal CDF (cf. ``pymc3/math.py:211``)."""
    return apply(jss.ndtri, p)


def invprobit(x):
    """Standard-normal CDF (cf. ``pymc3/math.py:215``)."""
    return apply(jss.ndtr, x)


def log1pexp(x):
    """log(1 + exp(x)), numerically stable (softplus)."""
    return apply(lambda v: jnp.logaddexp(0.0, v), x)


def _log1mexp(x):
    # log(1 - exp(-x)) for x > 0, switching formulations at log(2)
    # (cf. pymc3/math.py:156 after Machler 2012)
    x = jnp.asarray(x)
    return jnp.where(
        x < 0.6931471805599453,
        jnp.log(-jnp.expm1(-jnp.where(x < 0.6931471805599453, x, 1.0))),
        jnp.log1p(-jnp.exp(-jnp.where(x < 0.6931471805599453, 1.0, x))),
    )


def log1mexp(x):
    """log(1 - exp(-x)), stable for both small and large x."""
    return apply(_log1mexp, x)


def log1mexp_numpy(x):
    x = np.asarray(x, dtype=float)
    out = np.empty_like(x)
    small = x < 0.6931471805599453
    out[small] = np.log(-np.expm1(-x[small]))
    out[~small] = np.log1p(-np.exp(-x[~small]))
    return out


def logaddexp(a, b):
    return apply(jnp.logaddexp, a, b)


def logdiffexp(a, b):
    """log(exp(a) - exp(b)), cf. ``pymc3/math.py:166``."""
    return apply(lambda x, y: x + _log1mexp(x - y), a, b)


def logsumexp(x, axis=None, keepdims=True):
    """cf. ``pymc3/math.py:121`` (keepdims=True default matches reference)."""
    return apply(lambda v: jss.logsumexp(v, axis=axis, keepdims=keepdims), x)


def softmax(x, axis=-1):
    return apply(lambda v: jnp.exp(v - jss.logsumexp(v, axis=axis, keepdims=True)), x)


def log_softmax(x, axis=-1):
    return apply(lambda v: v - jss.logsumexp(v, axis=axis, keepdims=True), x)


# -- structural -------------------------------------------------------------
def dot(a, b):
    return apply(lambda x, y: jnp.dot(x, y, preferred_element_type=None), a, b)


matmul = _wrap(jnp.matmul)
outer = _wrap(jnp.outer)


def where(cond, a, b):
    return apply(jnp.where, cond, a, b)


switch = where  # theano name


def clip(x, lo, hi):
    return apply(jnp.clip, x, lo, hi)


def stack(*tensors, **kwargs):
    axis = kwargs.get("axis", 0)
    if len(tensors) == 1 and isinstance(tensors[0], (list, tuple)):
        tensors = tuple(tensors[0])
    return apply(lambda *ts: jnp.stack(ts, axis=axis), *tensors)


def concatenate(tensor_list, axis=0):
    return apply(lambda *ts: jnp.concatenate(ts, axis=axis), *tensor_list)


def sum(x, axis=None, keepdims=False):
    return apply(lambda v: jnp.sum(v, axis=axis, keepdims=keepdims), x)


def prod(x, axis=None, keepdims=False):
    return apply(lambda v: jnp.prod(v, axis=axis, keepdims=keepdims), x)


def mean(x, axis=None, keepdims=False):
    return apply(lambda v: jnp.mean(v, axis=axis, keepdims=keepdims), x)


cumsum = _wrap(jnp.cumsum)
cumprod = _wrap(jnp.cumprod)
ones_like = _wrap(jnp.ones_like)
zeros_like = _wrap(jnp.zeros_like)
full_like = _wrap(jnp.full_like)
diag = _wrap(jnp.diag)
tril = _wrap(jnp.tril)
triu = _wrap(jnp.triu)


def extract_diag(x):
    return apply(jnp.diagonal, x)


def eye(n, m=None, k=0):
    return jnp.eye(n, m, k)


def constant(x, name=None):
    from .node import as_node
    return as_node(x, name=name)


def flatten(x):
    return apply(jnp.ravel, x)


def flatten_list(tensors):
    return concatenate([flatten(t) for t in tensors])


def flat_outer(a, b):
    return apply(lambda x, y: jnp.outer(x, y).ravel(), a, b)


# -- linear algebra --------------------------------------------------------
def cholesky(x, lower=True):
    import jax.scipy.linalg as jsl
    return apply(lambda m: jsl.cholesky(m, lower=lower), x)


def solve(a, b):
    return apply(jnp.linalg.solve, a, b)


def solve_lower(a, b):
    import jax.scipy.linalg as jsl
    return apply(lambda m, v: jsl.solve_triangular(m, v, lower=True), a, b)


def solve_upper(a, b):
    import jax.scipy.linalg as jsl
    return apply(lambda m, v: jsl.solve_triangular(m, v, lower=False), a, b)


def matrix_inverse(x):
    return apply(jnp.linalg.inv, x)


def logdet(m):
    """log|det(M)| for positive-definite M via slogdet.

    Replaces the reference's custom ``LogDet`` Op (``pymc3/math.py:174``) —
    ``jnp.linalg.slogdet`` already has a correct gradient under XLA.
    """
    return apply(lambda x: jnp.linalg.slogdet(x)[1], m)


def expand_packed_triangular(n, packed, lower=True, diagonal_only=False):
    """Convert a packed triangular vector to an (n, n) triangular matrix.

    cf. ``pymc3/math.py:219``. Uses static index arrays so XLA sees a gather —
    no dynamic shapes.
    """
    if diagonal_only:
        if lower:
            idx = np.arange(n) * (np.arange(n) + 3) // 2
        else:
            idx = np.arange(n) * (2 * n - np.arange(n) + 1) // 2
        return apply(lambda p: p[..., idx], packed)
    if lower:
        rows, cols = np.tril_indices(n)
    else:
        rows, cols = np.triu_indices(n)

    def _expand(p):
        out = jnp.zeros(p.shape[:-1] + (n, n), dtype=p.dtype)
        return out.at[..., rows, cols].set(p)

    return apply(_expand, packed)


def batched_diag(x):
    """Vector stack -> stack of diag matrices, or matrix stack -> diagonals.

    cf. ``BatchedDiag`` Op (``pymc3/math.py:263-308``).
    """
    def _bd(v):
        if v.ndim == 2:
            return jax.vmap(jnp.diag)(v)
        if v.ndim == 3:
            return jax.vmap(jnp.diagonal)(v)
        raise ValueError("batched_diag expects 2d or 3d input")
    import jax
    return apply(_bd, x)


def block_diagonal(matrices, sparse=False, format=None):
    """Stack of (k, n, m) matrices -> block-diagonal (k*n, k*m).

    cf. ``BlockDiagonalMatrix`` (``pymc3/math.py:311-373``); sparse output is
    not supported here, so `sparse` is accepted and ignored.
    """
    if isinstance(matrices, (list, tuple)):
        def _blk(*ms):
            import jax.scipy.linalg as jsl
            return jsl.block_diag(*ms)
        return apply(_blk, *matrices)

    def _blk_stack(m):
        k, n, p = m.shape
        out = jnp.zeros((k * n, k * p), dtype=m.dtype)
        for i in range(k):
            out = out.at[i * n:(i + 1) * n, i * p:(i + 1) * p].set(m[i])
        return out
    return apply(_blk_stack, matrices)


# -- Kronecker algebra (cf. pymc3/math.py:39-118) ---------------------------
def kronecker(*Ks):
    """Kronecker product of a sequence of matrices (``math.py:39``)."""
    def _kron(*ms):
        out = ms[0]
        for m in ms[1:]:
            out = jnp.kron(out, m)
        return out
    return apply(_kron, *Ks)


def cartesian(*arrays):
    """Cartesian product of 1d arrays, row-major (``math.py:62`` helper)."""
    arrays = [np.atleast_1d(np.asarray(a)) for a in arrays]
    grid = np.meshgrid(*arrays, indexing="ij")
    return np.stack([g.ravel() for g in grid], axis=-1)


def _kron_matrix_op(krons, m, op):
    r"""Apply op(K_i) across the Kronecker factorization to matrix m.

    Never materializes kron(K_1, ..., K_D); cf. ``kron_matrix_op``
    (``pymc3/math.py:62-99``). All reshapes are static so XLA maps the inner
    contractions onto matrix products.
    """
    def _apply(ms_and_m):
        *ms, x = ms_and_m
        if x.ndim == 1:
            x = x[:, None]
        n = x.shape[0]
        res = x
        for K in ms:
            kn = K.shape[1]
            # res: (n, cols) -> group rows into (kn, n//kn * cols)
            cols = res.shape[1]
            r = res.reshape(kn, n // kn * cols)
            r = op(K, r)
            out_rows = K.shape[0]
            r = r.reshape(out_rows, n // kn, cols)
            res = jnp.moveaxis(r, 0, 1).reshape(n // kn * out_rows, cols)
            n = res.shape[0]
        return res
    return apply(lambda *a: _apply(a), *krons, m)


def kron_matrix_op(krons, m, op):
    return _kron_matrix_op(krons, m, op)


def kron_dot(krons, m):
    return _kron_matrix_op(krons, m, lambda K, x: jnp.dot(K, x))


def kron_solve_lower(krons, m):
    import jax.scipy.linalg as jsl
    return _kron_matrix_op(krons, m, lambda K, x: jsl.solve_triangular(K, x, lower=True))


def kron_solve_upper(krons, m):
    import jax.scipy.linalg as jsl
    return _kron_matrix_op(krons, m, lambda K, x: jsl.solve_triangular(K, x, lower=False))


def kron_diag(*diags):
    """Kronecker product of diagonal vectors (``pymc3/math.py:101``)."""
    def _kd(*ds):
        out = ds[0]
        for d in ds[1:]:
            out = (out[:, None] * d[None, :]).ravel()
        return out
    return apply(_kd, *diags)


def floatX_array(x):
    from .config import floatX as _fx
    return _fx(np.asarray(x))


def largest_common_dtype(tensors):
    dtypes = [np.asarray(getattr(t, "test_value", t)).dtype for t in tensors]
    return np.result_type(*dtypes)
