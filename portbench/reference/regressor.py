"""The reference regressor: a functional ResNet (BasicBlock or Bottleneck,
torchvision's widths) with flax's BatchNorm, then the IEF head, in float32,
over a state dict keyed as the port's (`image_encoder.*`, `ief_module.*`).

`fp8=True` is the control's encoder: every convolution's input and weight
rounded to float8 e4m3 (one scale a tensor, its largest magnitude at 448),
then multiplied in float32, as an fp8 matmul with a wide accumulator.
"""

import torch
import torch.nn.functional as F

DEPTHS = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
          50: ("bottleneck", (3, 4, 6, 3)), 101: ("bottleneck", (3, 4, 23, 3)),
          152: ("bottleneck", (3, 8, 36, 3))}
NUM_PARAMS = 157
EPS = 1e-5
MOMENTUM = 0.1


def _fp8(t):
    """`t` rounded to float8 e4m3 at one scale; the gradient passes
    through the rounding unchanged."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t.detach())


def _conv(x, sd, name, stride=1, padding=0, fp8=False):
    w = sd[name + ".weight"]
    if fp8:
        x, w = _fp8(x), _fp8(w)
    return F.conv2d(x, w, None, stride, padding)


def _bn(x, sd, name, train):
    w, b = sd[name + ".weight"], sd[name + ".bias"]
    rm, rv = sd[name + ".running_mean"], sd[name + ".running_var"]
    if not train:
        return (x - rm[:, None, None]) / torch.sqrt(rv[:, None, None] + EPS) * w[:, None, None] \
            + b[:, None, None]
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp(x.square().mean(dim=(0, 2, 3)) - mean.square(), min=0.0)
    with torch.no_grad():
        rm.mul_(1.0 - MOMENTUM).add_(mean * MOMENTUM)
        rv.mul_(1.0 - MOMENTUM).add_(var * MOMENTUM)
    mul = torch.rsqrt(var + EPS) * w
    return (x - mean[:, None, None]) * mul[:, None, None] + b[:, None, None]


def _block(x, sd, name, kind, stride, train, fp8):
    ds = name + ".downsample"
    if ds + ".0.weight" in sd:
        identity = _bn(_conv(x, sd, ds + ".0", stride, 0, fp8), sd, ds + ".1", train)
    else:
        identity = x
    if kind == "basic":
        out = F.relu(_bn(_conv(x, sd, name + ".conv1", stride, 1, fp8), sd, name + ".bn1", train))
        out = _bn(_conv(out, sd, name + ".conv2", 1, 1, fp8), sd, name + ".bn2", train)
    else:
        out = F.relu(_bn(_conv(x, sd, name + ".conv1", 1, 0, fp8), sd, name + ".bn1", train))
        out = F.relu(_bn(_conv(out, sd, name + ".conv2", stride, 1, fp8), sd, name + ".bn2",
                         train))
        out = _bn(_conv(out, sd, name + ".conv3", 1, 0, fp8), sd, name + ".bn3", train)
    return F.relu(out + identity)


def encoder(x, sd, depth, train, fp8=False):
    """NCHW float32 -> (B, 512 or 2048) average-pooled features."""
    kind, layers = DEPTHS[depth]
    e = "image_encoder"
    x = F.relu(_bn(_conv(x, sd, e + ".conv1", 2, 3, fp8), sd, e + ".bn1", train))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, n in enumerate(layers):
        for b in range(n):
            x = _block(x, sd, f"{e}.layer{stage + 1}.{b}", kind,
                       2 if stage > 0 and b == 0 else 1, train, fp8)
    return x.mean(dim=(2, 3))


def initial_estimate(mean_pose_6d, mean_shape):
    init = torch.zeros(NUM_PARAMS, dtype=torch.float32, device=mean_shape.device)
    init[0] = 0.9
    init[3:147] = mean_pose_6d
    init[147:] = mean_shape
    return init


def forward(proxy, sd, depth, init, train, iters=3, fp8=False):
    """NHWC proxy -> (cam (B, 3), pose6d (B, 144), shape (B, 10))."""
    feats = encoder(proxy.permute(0, 3, 1, 2).float(), sd, depth, train, fp8)
    params = init.expand(feats.shape[0], NUM_PARAMS)
    h = "ief_module"
    for _ in range(iters):
        s = torch.cat([feats, params], dim=1)
        s = F.relu(F.linear(s, sd[h + ".fc1.weight"], sd[h + ".fc1.bias"]))
        s = F.relu(F.linear(s, sd[h + ".fc2.weight"], sd[h + ".fc2.bias"]))
        params = params + F.linear(s, sd[h + ".fc3.weight"], sd[h + ".fc3.bias"])
    return params[:, :3], params[:, 3:147], params[:, 147:]
