"""FID InceptionV3 feature extractor (pool3, logits and the sFID tap).

Port of ``ln3diff_tpu/evaluation/inception.py`` (``BasicConv2d`` :35,
``InceptionA``–``InceptionE`` :92-210, ``InceptionV3`` :219,
``convert_inception_state_dict`` :296, ``preprocess_uint8`` :317): the
"FID Inception" network of pytorch-fid (``pt_inception-2015-12-05``, a
port of the TF1 graph of the reference evaluator,
``evaluations/evaluator.py:20-66``).  Parameters and buffers carry the
pytorch-fid / torchvision names (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_var``, ``fc.weight`` …), so a pytorch-fid
state dict loads with ``load_state_dict`` as it is; its auxiliary
classifier (``AuxLogits.*``) is ignored, as the JAX converter ignores it.

Quirks kept (each moves FID if dropped):
  * convs without bias, then BatchNorm at eps 1e-3 with frozen statistics,
    folded into a scale and shift in f32;
  * the pool branches of InceptionA, InceptionC and the first InceptionE
    average 3x3 windows over their in-bounds taps only
    (``count_include_pad=False``);
  * the last InceptionE max-pools 3x3 at stride 1 in its pool branch;
  * 1008 logits (the TF graph's background classes);
  * ``pool3`` is the spatial mean of the last block.

Input: (N, 299, 299, 3) channels-last in [-1, 1], as in JAX; the convs
run channels-first.  The sFID features are the pre-BN output of
``Mixed_6d.branch1x1``'s conv (the TF graph's ``mixed_6/conv:0``), its
first 7 channels flattened in channels-last order: 7·17² = 2023.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BasicConv2d(nn.Module):
    """conv (no bias) → BN (eps 1e-3, frozen statistics) → relu."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def reset_free_parameters(self, generator=None):
        """The JAX init of the BN: scale 1, shift 0 (the statistics are
        buffers at 0 and 1 already)."""
        with torch.no_grad():
            self.bn.weight.fill_(1.0)
            self.bn.bias.zero_()

    def forward(self, x):
        x = self.conv(x)
        bn = self.bn
        inv = torch.rsqrt(bn.running_var.float() + 1e-3) * bn.weight.float()
        shift = bn.bias.float() - bn.running_mean.float() * inv
        x = x.float() * inv[:, None, None] + shift[:, None, None]
        return F.relu(x)


def _avg_pool_nocountpad(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nocountpad(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = F.max_pool2d(x, 3, stride=2)
        return torch.cat([b3, bd, bp], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                      self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_nocountpad(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3,
                      self.branch7x7x3_4):
            b7 = layer(b7)
        bp = F.max_pool2d(x, 3, stride=2)
        return torch.cat([b3, b7, bp], dim=1)


class InceptionE(nn.Module):
    """``pool='avg'`` (the first E block, ``count_include_pad=False``) or
    ``pool='max'`` (the last block: the FID network's deviation from
    torchvision)."""

    def __init__(self, cin: int, pool: str = 'avg'):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        if self.pool == 'max':
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool_nocountpad(x)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """(N, 299, 299, 3) in [-1, 1] → ``pool3`` (N, 2048), ``logits`` (N,
    ``num_classes``) and ``spatial`` (N, 2023), all f32."""

    def __init__(self, num_classes: int = 1008):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, 'avg')
        self.Mixed_7c = InceptionE(2048, 'max')
        self.fc = nn.Linear(2048, num_classes)

    def load_state_dict(self, state_dict, strict: bool = True, assign=False):
        """A pytorch-fid / torchvision ``Inception3`` state dict, its
        auxiliary classifier (``AuxLogits.*``) dropped."""
        sd = {k: v for k, v in state_dict.items()
              if not k.startswith('AuxLogits.')}
        return super().load_state_dict(sd, strict=strict, assign=assign)

    def forward(self, x: torch.Tensor) -> dict:
        taps = {}
        hook = self.Mixed_6d.branch1x1.conv.register_forward_hook(
            lambda mod, args, out: taps.__setitem__('conv', out))
        try:
            x = x.float().permute(0, 3, 1, 2)
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = F.max_pool2d(x, 3, stride=2)
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            x = F.max_pool2d(x, 3, stride=2)
            for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                          self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                          self.Mixed_6d, self.Mixed_6e, self.Mixed_7a,
                          self.Mixed_7b, self.Mixed_7c):
                x = block(x)
        finally:
            hook.remove()
        pool3 = x.mean(dim=(2, 3))
        sp = taps['conv'][:, :7].float()
        return {'pool3': pool3, 'logits': self.fc(pool3),
                'spatial': sp.permute(0, 2, 3, 1).reshape(x.shape[0], -1)}


def preprocess_uint8(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """uint8 (N, H, W, 3) → bilinear-resized (antialiased when it shrinks,
    as ``jax.image.resize``) float input in [-1, 1], channels-last."""
    x = images.float()
    if images.shape[1] != size or images.shape[2] != size:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode='bilinear', align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    return x / 127.5 - 1.0
