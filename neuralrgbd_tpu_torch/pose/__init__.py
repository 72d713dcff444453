"""Pose estimation for the pose-free pipeline (counterpart of
``neuralrgbd_tpu/pose``): the photometric LBA (``lba``) and the DSO
visual-odometry driver (``dso``)."""
from neuralrgbd_tpu_torch.pose.lba import local_ba_direct, make_lba_optimizer
from neuralrgbd_tpu_torch.pose import dso
