from stswincl_tpu_torch.models.pixpro import ContrastEncoder
from stswincl_tpu_torch.models.stswin import DeepLabV3Plus, TswinPlus
from stswincl_tpu_torch.models.swin import SwinTemporalStack

__all__ = ["ContrastEncoder", "DeepLabV3Plus", "TswinPlus",
           "SwinTemporalStack"]
