"""Diffusion schedulers of the port (flow matching, DDIM, the continuous ODE
scheduler, the flow-matching solvers). svi_tpu's exports, imported at first
access."""

from .._exports import lazy_exports

_EXPORTS = {
    "ContinuousODEScheduler": "continuous_ode",
    "FlowDPMSolverMultistepScheduler": "fm_solvers",
    "FlowUniPCMultistepScheduler": "fm_solvers",
    "get_sampling_sigmas": "fm_solvers",
    "retrieve_timesteps": "fm_solvers",
    "EnhancedDDIMScheduler": "ddim",
    "FlowMatchSchedule": "flow_match",
    "FlowMatchScheduler": "flow_match",
    "add_noise": "flow_match",
    "make_schedule": "flow_match",
    "return_to_timestep": "flow_match",
    "step": "flow_match",
    "training_target": "flow_match",
    "training_weight": "flow_match",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
