from nbss_tpu_torch.io.stft import STFT, PARAS_8K, PARAS_16K
from nbss_tpu_torch.io.norm import Norm, forgetting_normalization
from nbss_tpu_torch.io.loss import (
    Loss,
    neg_si_sdr,
    neg_sa_sdr,
    neg_snr,
    cirm_mse,
    cc_mse,
    resolve_loss_func,
)
from nbss_tpu_torch.io.cirm import (
    build_complex_ideal_ratio_mask,
    compress_cirm,
    decompress_cirm,
)

__all__ = [
    "STFT", "PARAS_8K", "PARAS_16K", "Norm", "forgetting_normalization",
    "Loss", "neg_si_sdr", "neg_sa_sdr", "neg_snr", "cirm_mse", "cc_mse",
    "resolve_loss_func", "build_complex_ideal_ratio_mask", "compress_cirm",
    "decompress_cirm",
]
