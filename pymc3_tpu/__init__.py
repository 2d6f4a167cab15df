"""pymc3_tpu — a probabilistic programming framework on JAX.

A ground-up rebuild of the capabilities of PyMC3 3.8 (the Theano-backed PPL)
on JAX/XLA for accelerators: the model DSL traces to one fused XLA logp+grad program,
MCMC chains are a ``vmap`` batch axis sharded over device meshes, and all hot
loops (NUTS tree building, leapfrog, VI steps, SMC mutation) run as on-device
``lax`` control flow.

Flat ``pm.*`` API surface mirrors ``pymc3/__init__.py:18-50``.
"""

__version__ = "3.8.0.jax0"

import logging

_log = logging.getLogger("pymc3_tpu")
if not logging.root.handlers:
    _log.setLevel(logging.INFO)
    if len(_log.handlers) == 0:
        handler = logging.StreamHandler()
        _log.addHandler(handler)

from .config import floatX, intX, get_config, set_config
from .config import _apply_floatX as _afx, _apply_matmul_precision as _ammp

_afx()
_ammp()
del _afx, _ammp
from . import node
from . import math
from .math import (
    logsumexp, logaddexp, logit, invlogit, expand_packed_triangular,
    probit, invprobit,
)
from .model import (
    Model, modelcontext, Point, Deterministic, Potential, set_data,
    ValueGradFunction, fn, fastfn, compilef, FreeRV, ObservedRV,
    TransformedRV, Factor,
)
from .blocking import (
    ArrayOrdering, DictToArrayBijection, DictToVarBijection,
)
from .data import Data, Minibatch, get_data, GeneratorAdapter, align_minibatches
from . import jaxf
from .jaxf import (
    gradient, hessian, hessian_diag, jacobian, inputvars, cont_inputs,
    smartfloatX, CallableTensor, join_nonshared_inputs,
    make_shared_replacements, generator, tt_rng, set_tt_rng, take_along_axis,
)
from .distributions import *
from .distributions import transforms
from . import distributions
from .exceptions import *
from .memoize import memoize, clear_cache
from .vartypes import *

from . import step_methods
from .step_methods import (
    NUTS, HamiltonianMC, Metropolis, BinaryMetropolis, BinaryGibbsMetropolis,
    CategoricalGibbsMetropolis, DEMetropolis, DEMetropolisZ, Slice,
    EllipticalSlice, ElemwiseCategorical, CompoundStep,
)
from .step_methods.metropolis import (
    NormalProposal, UniformProposal, CauchyProposal, LaplaceProposal,
    PoissonProposal, MultivariateNormalProposal,
)
from . import backends
from .backends.base import MultiTrace, merge_traces
from .backends.ndarray import (
    NDArray, save_trace, load_trace, point_list_to_multitrace,
)
from .backends.tracetab import trace_to_dataframe
from .backends.inferencedata import InferenceData, to_inference_data
from .backends.report import SamplerReport, SamplerWarning, WarningType
from .sampling import (
    sample, iter_sample, init_nuts, sample_prior_predictive,
    sample_posterior_predictive, sample_posterior_predictive_w,
    fast_sample_posterior_predictive, stop_tuning, assign_step_methods,
)
from . import stats
from .stats import (
    bfmi, compare, ess, geweke, hpd, loo, mcse, r2_score, rhat, summary, waic,
    effective_n, gelman_rubin, map_args,
)
from .tuning import (
    find_MAP, find_hessian, guess_scaling, trace_cov,
)
from . import parallel

from . import variational
from .variational import (
    ADVI, ASVGD, NFVI, SVGD, FullRankADVI, Empirical, FullRank, MeanField,
    NormalizingFlow, KLqp, fit, sample_approx, Inference, ImplicitGradient,
    Approximation, Group,
)
from .variational import (
    approximations, callbacks, flows, inference, operators, opvi,
    test_functions, updates,
)
from .variational.stein import Stein
from .variational.updates import (
    sgd, momentum, nesterov_momentum, adagrad, adagrad_window, rmsprop,
    adadelta, adam, adamax, norm_constraint, total_norm_constraint,
    apply_momentum, apply_nesterov_momentum,
)
from .glm import families
from .smc import sample_smc, SMC

from . import gp
from . import glm
from .glm import GLM, LinearComponent
from . import ode
from .ode import DifferentialEquation
from . import plots
from .plots import (
    traceplot, plot_posterior, forestplot, energyplot, autocorrplot,
    densityplot, kdeplot, pairplot, compareplot,
    plot_posterior_predictive_glm,
)
from .model_graph import model_to_graphviz


# compat shim: the reference leaks `theano.tensor.constant` into pm.* via
# star imports (sampling.py imports it as theano_constant); here a constant
# is just a wrapped concrete array node.
from .node import as_node as theano_constant  # noqa: E402


def test(*args, **kwargs):
    """Run the test suite (cf. ``pymc3/__init__.py:50`` ``from .tests import
    test``) — delegates to pytest on the installed package's tests."""
    import os
    import pytest

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return pytest.main([os.path.join(here, "tests"), *args])
