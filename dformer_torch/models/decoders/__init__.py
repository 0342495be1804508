from dformer_torch.models.decoders.deeplabv3p import DeepLabV3Plus
from dformer_torch.models.decoders.fcn import FCNHead
from dformer_torch.models.decoders.ham import LightHamHead
from dformer_torch.models.decoders.mlp import MLPDecoderHead
from dformer_torch.models.decoders.nl import NLHead
from dformer_torch.models.decoders.upernet import UPerHead

__all__ = ["DeepLabV3Plus", "FCNHead", "LightHamHead", "MLPDecoderHead",
           "NLHead", "UPerHead"]
