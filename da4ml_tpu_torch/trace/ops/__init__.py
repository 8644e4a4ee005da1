from .conv_utils import (
    avg_pool1d,
    avg_pool2d,
    conv1d,
    conv2d,
    depthwise_conv1d,
    depthwise_conv2d,
    max_pool1d,
    max_pool2d,
    upsample_nearest,
    zero_pad,
)
from .einsum_utils import einsum
from .quantization import fixed_quantize, leaky_relu, quantize, relu, relu6
from .reduce_utils import reduce
from .sorting import sort

__all__ = [
    'einsum',
    'quantize',
    'leaky_relu',
    'relu',
    'relu6',
    'reduce',
    'sort',
    'fixed_quantize',
    'conv1d',
    'conv2d',
    'depthwise_conv1d',
    'depthwise_conv2d',
    'max_pool1d',
    'max_pool2d',
    'avg_pool1d',
    'avg_pool2d',
    'zero_pad',
    'upsample_nearest',
]
