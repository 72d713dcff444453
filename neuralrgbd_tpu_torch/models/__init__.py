"""D-Net feature extractor, K-Net, R-Net, KVNet and the refine heads as
nn.Modules (the JAX package's ``models`` exports)."""

from neuralrgbd_tpu_torch.models.feature_extractor import FeatureExtractor
from neuralrgbd_tpu_torch.models.guided_filter import RefineNetDGF
from neuralrgbd_tpu_torch.models.knet import KNet
from neuralrgbd_tpu_torch.models.kvnet import KVNet, KVNetOutput
from neuralrgbd_tpu_torch.models.refine_legacy import (RefineNet3D,
                                                       RefineNetDeMoN,
                                                       RefineNetUnet2D,
                                                       RefineNetUNet3D)
from neuralrgbd_tpu_torch.models.rnet import RNet
