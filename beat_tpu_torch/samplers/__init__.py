"""Samplers of the port: lockstep adaptive Metropolis, MALA, HMC and SMC."""

from beat_tpu_torch.samplers.metropolis import (MetropolisParams,  # noqa: F401
                                                MetropolisState, hmc_step,
                                                init_metropolis_state, mala_step,
                                                metropolis_sample, metropolis_step,
                                                run_metropolis_stage, tune_scale,
                                                value_and_grad)
from beat_tpu_torch.samplers.smc import (SMCParams, calc_beta,  # noqa: F401
                                         calc_covariance, smc_sample, systematic_resample)
