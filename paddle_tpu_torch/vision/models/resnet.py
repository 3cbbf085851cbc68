"""ResNet: counterpart of ``paddle_tpu/vision/models/resnet.py``.

The same blocks, widths and state-dict keys (``conv1``, ``bn1``,
``layer1.0.conv1``, ..., ``fc``; BatchNorm's running statistics as
``_mean`` / ``_variance``), NCHW at the API; the convolutions run through
``nn.functional.conv2d`` (cuDNN on the card). ``x.flatten(1)`` keeps
torch's meaning, which is Paddle's here. Every constructor takes a
keyword-only ``device`` (default: the card). ``load_paddle_tpu_state`` /
``paddle_tpu_state`` (``models/gpt.py``) carry weights by the JAX keys.
"""
from __future__ import annotations

from functools import partial

from ... import nn

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "wide_resnet50_2", "wide_resnet101_2"]


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None):
        super().__init__()
        norm_layer = norm_layer or partial(nn.BatchNorm2D, device=device)
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, device=device)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               device=device)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None):
        super().__init__()
        norm_layer = norm_layer or partial(nn.BatchNorm2D, device=device)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False,
                               device=device)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride,
                               padding=dilation, groups=groups,
                               dilation=dilation, bias_attr=False,
                               device=device)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, device=device)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    def __init__(self, block, depth=None, layers=None, num_classes=1000,
                 with_pool=True, groups=1, width_per_group=64, *,
                 device=None):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layers or layer_cfg[depth]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.groups = groups
        self.base_width = width_per_group
        self.inplanes = 64
        self.dilation = 1
        self._device = device

        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, device=device)
        self.bn1 = nn.BatchNorm2D(self.inplanes, device=device)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                device=device)

    def _make_layer(self, block, planes, blocks, stride=1):
        dev = self._device
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, device=dev),
                nn.BatchNorm2D(planes * block.expansion, device=dev))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, device=dev)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, device=dev))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights unavailable offline; "
                                  "load a state_dict explicitly")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kw):
    return _resnet(BasicBlock, 18, pretrained, **kw)


def resnet34(pretrained=False, **kw):
    return _resnet(BasicBlock, 34, pretrained, **kw)


def resnet50(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 50, pretrained, **kw)


def resnet101(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 101, pretrained, **kw)


def resnet152(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 152, pretrained, **kw)


def wide_resnet50_2(pretrained=False, **kw):
    kw["width_per_group"] = 128
    return _resnet(BottleneckBlock, 50, pretrained, **kw)


def wide_resnet101_2(pretrained=False, **kw):
    kw["width_per_group"] = 128
    return _resnet(BottleneckBlock, 101, pretrained, **kw)
