from stswincl_tpu_torch.models.stswin import TswinPlus
from stswincl_tpu_torch.models.swin import SwinTemporalStack

__all__ = ["TswinPlus", "SwinTemporalStack"]
