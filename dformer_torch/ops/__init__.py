from dformer_torch.ops.pool import adaptive_avg_pool2d, global_avg_pool2d
from dformer_torch.ops.resize import resize_bilinear

__all__ = ["adaptive_avg_pool2d", "global_avg_pool2d", "resize_bilinear"]
