from nbss_tpu_torch.sim.ism import (
    beta_from_t60,
    sabine_t60,
    simulate_direct_path,
    simulate_rir,
)
from nbss_tpu_torch.sim.config import RirConfigSampler, rotate_positions
from nbss_tpu_torch.sim.trajectory import four_points_sin_trajectory
from nbss_tpu_torch.sim.generate import generate_rir_files, render_room

__all__ = [
    "simulate_rir", "simulate_direct_path", "beta_from_t60", "sabine_t60",
    "RirConfigSampler", "rotate_positions", "four_points_sin_trajectory",
    "generate_rir_files", "render_room",
]
