"""Samplers of the port: lockstep adaptive Metropolis and SMC."""

from beat_tpu_torch.samplers.metropolis import (MetropolisState,  # noqa: F401
                                                init_metropolis_state, metropolis_step,
                                                run_metropolis_stage, tune_scale)
from beat_tpu_torch.samplers.smc import (SMCParams, calc_beta,  # noqa: F401
                                         calc_covariance, smc_sample, systematic_resample)
