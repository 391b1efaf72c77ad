from nbss_tpu_torch.data.sampler import BatchLoader, DistributedSampler
from nbss_tpu_torch.data.synthetic import SyntheticDataset
from nbss_tpu_torch.data.loader import DataModule
from nbss_tpu_torch.data import mixing
from nbss_tpu_torch.data.diffuse import gen_diffuse_noise, spatial_coherence_mixing_matrices
from nbss_tpu_torch.data.windows import rts_window, rectangular_window
from nbss_tpu_torch.data import geometry

__all__ = [
    "BatchLoader", "DistributedSampler", "SyntheticDataset", "DataModule",
    "mixing", "gen_diffuse_noise", "spatial_coherence_mixing_matrices",
    "rts_window", "rectangular_window", "geometry",
]
