"""Samplers of the port: lockstep adaptive Metropolis, MALA and HMC, SMC
and parallel tempering."""

from beat_tpu_torch.samplers.metropolis import (MetropolisParams,  # noqa: F401
                                                MetropolisState, hmc_step,
                                                init_metropolis_state, mala_step,
                                                metropolis_sample, metropolis_step,
                                                run_metropolis_stage, tune_scale,
                                                value_and_grad)
from beat_tpu_torch.samplers.pt import (PTParams, make_betas, pt_sample,  # noqa: F401
                                        swap_step, tune_temp_scale)
from beat_tpu_torch.samplers.smc import (SMCParams, calc_beta,  # noqa: F401
                                         calc_covariance, smc_sample, systematic_resample)
