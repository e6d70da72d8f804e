from occuseg.nn.modules import (
    BLInputLayer,
    BLOutputLayer,
    AveragePooling,
    BatchNormalization,
    BatchNormLeakyReLU,
    BatchNormReLU,
    Convolution,
    Deconvolution,
    InputLayer,
    MaxPooling,
    NetworkInNetwork,
    OutputLayer,
    SubmanifoldConvolution,
    UnPooling,
)
from occuseg.nn.unet import UNet, FullyConvolutionalNet, SparseResNet, SparseVggNet
