from nbss_tpu_torch.eval.scale import recover_scale
from nbss_tpu_torch.eval.metrics import cal_metrics
from nbss_tpu_torch.eval.stoi import stoi

__all__ = ["recover_scale", "cal_metrics", "stoi"]
