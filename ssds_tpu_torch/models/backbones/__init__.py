"""Backbone zoo: builders returning flat layer-spec lists.

Integer ``FEATURE_LAYER`` entries index into the list, so its layout is the
API (documented in each module). Only ``vgg16`` is ported so far.
"""

from ssds_tpu_torch.models.backbones.vgg import vgg16

networks_map = {
    "vgg16": vgg16,
}
