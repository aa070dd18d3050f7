"""PointNet++ multi-scale-grouping (MSG) semantic segmentation
(``tumseg/models/pointnet2_sem_seg_msg.py``): four MSG set abstractions
(1024/256/64/16 centroids, two radii each with K = 16 and 32), the feature
propagations and head of the SSG model, and its forward, draws and loss."""

from __future__ import annotations

from tumseg_torch.models.pointnet2_sem_seg import PointNet2SemSeg
from tumseg_torch.nn.layers import SetAbstractionMsg

SA_CFGS = [
    dict(npoint=1024, radius_list=[0.05, 0.1], nsample_list=[16, 32],
         mlp_list=[[16, 16, 32], [32, 32, 64]]),
    dict(npoint=256, radius_list=[0.1, 0.2], nsample_list=[16, 32],
         mlp_list=[[64, 64, 128], [64, 96, 128]]),
    dict(npoint=64, radius_list=[0.2, 0.4], nsample_list=[16, 32],
         mlp_list=[[128, 196, 256], [128, 196, 256]]),
    dict(npoint=16, radius_list=[0.4, 0.8], nsample_list=[16, 32],
         mlp_list=[[256, 256, 512], [256, 384, 512]]),
]
FP_CFGS = [
    dict(in_channel=512 + 512 + 256 + 256, mlp=[256, 256]),   # fp4
    dict(in_channel=128 + 128 + 256, mlp=[256, 256]),          # fp3
    dict(in_channel=32 + 64 + 256, mlp=[256, 128]),            # fp2
    dict(in_channel=128, mlp=[128, 128, 128]),                 # fp1
]


class PointNet2SemSegMsg(PointNet2SemSeg):
    fp_cfgs = FP_CFGS

    def add_set_abstractions(self, in_ch: int) -> None:
        """Registers ``sa1``..``sa4``; each MSG layer adds the 3 centred
        xyz channels itself."""
        for i, cfg in enumerate(SA_CFGS, start=1):
            setattr(self, f"sa{i}", SetAbstractionMsg(
                cfg["npoint"], cfg["radius_list"], cfg["nsample_list"],
                in_ch, cfg["mlp_list"]))
            in_ch = sum(mlp[-1] for mlp in cfg["mlp_list"])


def get_model(num_classes: int, num_extra_features: int = 0
              ) -> PointNet2SemSegMsg:
    return PointNet2SemSegMsg(num_classes, num_extra_features)
