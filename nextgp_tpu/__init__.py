"""nextgp_tpu — Bayesian genomic prediction on GPUs.

A from-scratch JAX/XLA/Pallas re-design of the method surface of
`datasciencetoolkit/NextGP.jl`:
whole-genome Bayesian regression (BayesPR/A/B/C/R/RCpi/RCplus/LV),
Henderson mixed-model random effects (pedigree/GBLUP), summary-statistic
priors, and the GRN structural-equation sampler — built around
device-resident int8 or 2-bit packed genotypes, blocked-Gram single-site
Gibbs with the in-block chain in one Triton kernel, column-sharded marker
matrices with psum-merged residual corrections, data-parallel chains.
"""
from .api.priors import (  # noqa: F401
    BayesB,
    BayesC,
    BayesLV,
    BayesPR,
    BayesR,
    BayesRCpi,
    BayesRCplus,
    Random,
    RandomEffect,
    SummaryStatistics,
)
from .api.formula import parse_formula  # noqa: F401
from .api.spec import CorrMarkerTerm, FixedTerm, MarkerTerm, ModelSpec, RandomTerm  # noqa: F401
from .data.grm import make_g, make_g_inverse  # noqa: F401
from .data.ingest import (  # noqa: F401
    MarkerData,
    from_array,
    from_float_array,
    from_packed,
    read_genotype_file,
    read_plink,
)
from .data.pedigree import build_pedigree, make_a, read_pedigree  # noqa: F401
from .engine.plan import assemble  # noqa: F401
from .engine.sweep import make_sweep  # noqa: F401
from .io.summary import ess_bulk, posterior_stats, split_rhat, summary_mcmc  # noqa: F401
from .grn.sampler import est_grn  # noqa: F401
from .runtime import LMEMResult, model_card, prep, run_chains, run_lmem  # noqa: F401
from .predict import genomic_values, genomic_values_state, predict  # noqa: F401

__version__ = "0.1.0"
