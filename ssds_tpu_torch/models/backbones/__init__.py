"""Backbone zoo: builders returning flat layer-spec lists.

Integer ``FEATURE_LAYER`` entries index into the list, so its layout is the
API (documented in each module). Every backbone of the JAX package is
ported: ``vgg16``, the eight MobileNets, ``resnet_{18,34,50,101}``,
``darknet_19`` and ``darknet_53``.
"""

from ssds_tpu_torch.models.backbones import darknet, mobilenet, resnet
from ssds_tpu_torch.models.backbones.vgg import vgg16

networks_map = {
    "vgg16": vgg16,
    "mobilenet_v1": mobilenet.mobilenet_v1,
    "mobilenet_v1_075": mobilenet.mobilenet_v1_075,
    "mobilenet_v1_050": mobilenet.mobilenet_v1_050,
    "mobilenet_v1_025": mobilenet.mobilenet_v1_025,
    "mobilenet_v2": mobilenet.mobilenet_v2,
    "mobilenet_v2_075": mobilenet.mobilenet_v2_075,
    "mobilenet_v2_050": mobilenet.mobilenet_v2_050,
    "mobilenet_v2_025": mobilenet.mobilenet_v2_025,
    "resnet_18": resnet.resnet_18,
    "resnet_34": resnet.resnet_34,
    "resnet_50": resnet.resnet_50,
    "resnet_101": resnet.resnet_101,
    "darknet_19": darknet.darknet_19,
    "darknet_53": darknet.darknet_53,
}
