from nbss_tpu_torch.models.spatialnet import SpatialNet, SpatialNetLayer
from nbss_tpu_torch.models.nbc import NBC, NBCBlock, RelPosMultiHeadAttention
from nbss_tpu_torch.models.nbc2 import NBC2, NBC2Block
from nbss_tpu_torch.models.nb_blstm import BLSTM2_FC1, BiLSTM
from nbss_tpu_torch.models.nbss import NBSS
from nbss_tpu_torch.models.online_spatialnet import OnlineSpatialNet, OnlineSpatialNetLayer
from nbss_tpu_torch.models.retention import MultiScaleRetention, RetNetRelPos
from nbss_tpu_torch.models.mamba import MambaBlock

__all__ = [
    "SpatialNet", "SpatialNetLayer", "NBC", "NBCBlock",
    "RelPosMultiHeadAttention", "NBC2", "NBC2Block", "BLSTM2_FC1", "BiLSTM",
    "NBSS", "OnlineSpatialNet", "OnlineSpatialNetLayer", "MultiScaleRetention",
    "RetNetRelPos", "MambaBlock",
]
