"""Visualisation renders (counterpart of `straps_tpu/render/vis.py`).

The reference's pyrender scene is replaced by the face-id rasteriser plus
a per-face lit colour: `render_body_vis` draws predicted bodies, lit
(`style="lit"`) or body-part coloured (`style="parts"`), composited over
images of any size (resized as cv2's float INTER_LINEAR does), and
`proxy_vis` the silhouette + summed heatmaps of a proxy.  The detector
overlays: `silhouette_overlay_vis` (cv2.addWeighted of the mask at half
opacity), `keypoints_vis` (cv2's filled circles of radius 5 and the
joint indices cv2.putText writes) and `densepose_overlay_vis`
(matplotlib's viridis of the part labels, blended by cv2.addWeighted
0.6/0.4).  matplotlib's figures of the vertices, `verts_over_image_vis`
and `scatter_vis`, are in `render/figures.py`.  All write uint8 pixels;
the files are PNGs from `utils/png.py`.  Batched over bodies on the
tensors' device: one face-id rasterisation for a whole batch.
"""

import base64
import zlib
from typing import Optional, Sequence, Union

import numpy as np
import torch

from straps_tpu_torch.geometry.camera import (
    get_intrinsics_matrix, weak_perspective_to_camera_translation,
)
from straps_tpu_torch.render.figures import scatter_vis, verts_over_image_vis  # noqa: F401
from straps_tpu_torch.render.raster import face_ids_to_parts
from straps_tpu_torch.render.renderer import render_face_ids
from straps_tpu_torch.utils.image import cv2_resize_linear_f32
from straps_tpu_torch.utils.png import write_png

# Part colours (bg + 6 parts), RGB in [0,1].
PART_COLORS = np.asarray([
    [0.0, 0.0, 0.0], [0.9, 0.3, 0.3], [0.3, 0.5, 0.9], [0.9, 0.8, 0.3],
    [0.4, 0.8, 0.4], [0.7, 0.4, 0.8], [0.8, 0.6, 0.45],
], np.float32)

# The reference's pyrender scene (`renderers/weak_perspective_pyrender_
# renderer.py:50-95`): ambient light 0.3; two white point lights of
# intensity 1.0 at (0, -1, 1) and (0, 1, 1) in the GL world frame (camera
# pose = identity, mesh transformed by Rx(180deg)); a metallic-roughness
# material with metallic 0.2, base colour (0.8, 0.3, 0.3) and roughness
# 1.0.  pyrender's shader is the glTF 2.0 metallic-roughness BRDF with
# inverse-square point lights and a 1/2.2 gamma on output.
LIT_AMBIENT = 0.3
LIT_LIGHT_POSITIONS = np.asarray([[0.0, -1.0, 1.0], [0.0, 1.0, 1.0]], np.float32)
LIT_LIGHT_INTENSITY = 1.0
LIT_BASE_COLOR = np.asarray([0.8, 0.3, 0.3], np.float32)
LIT_METALLIC = 0.2
LIT_ROUGHNESS = 1.0

# matplotlib's 'gray' colormap as bytes: entry i of its 256-entry table.
_GRAY_LEVELS = (np.linspace(0.0, 1.0, 256) * 255).astype(np.uint8)
# matplotlib's 'viridis' colormap as bytes: its 256 RGB entries, as
# `matplotlib.colormaps["viridis"](np.arange(256), bytes=True)[:, :3]`.
_VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
    "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
    "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
    "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
    "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"), np.uint8).reshape(256, 3)
_FLIP_YZ = (1.0, -1.0, -1.0)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def lit_face_colors(verts: torch.Tensor, faces: torch.Tensor,
                    base_color=LIT_BASE_COLOR) -> torch.Tensor:
    """Per-face shaded RGB under the reference's two-point-light scene.

    Args:
      verts: (B, V, 3) model-space vertices; faces: (F, 3) int.
    Returns:
      (B, F, 3) in [0, 1], gamma-corrected: the glTF 2.0
      metallic-roughness BRDF with the scene constants above, flat-shaded
      per face (geometric normal, centroid as the fragment position).  The
      reference renders the mesh after Rx(180deg), so the lighting frame is
      (x, -y, -z) with the camera at the origin looking down -z.
    """
    dev = verts.device
    v = verts.to(torch.float32) * torch.tensor(_FLIP_YZ, device=dev)
    tri = v[:, faces.long()]                                    # (B, F, 3, 3)
    n = _unit(torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :],
                                 tri[..., 2, :] - tri[..., 0, :]))
    p = tri.mean(dim=-2)                                        # centroids
    view = _unit(-p)
    # Normals face the viewer: only front faces survive the depth test.
    n = torch.where((n * view).sum(-1, keepdim=True) < 0.0, -n, n)

    base = torch.as_tensor(np.asarray(base_color, np.float32), device=dev)
    c_diff = base * (1.0 - 0.04) * (1.0 - LIT_METALLIC)
    f0 = 0.04 * (1.0 - LIT_METALLIC) + base * LIT_METALLIC
    alpha = LIT_ROUGHNESS ** 2
    n_dot_v = (n * view).sum(-1, keepdim=True).clamp(1e-3, 1.0)

    color = torch.full(tri.shape[:2] + (3,), LIT_AMBIENT, device=dev) * base
    for light_pos in torch.as_tensor(LIT_LIGHT_POSITIONS, device=dev):
        lvec = light_pos - p
        dist = torch.linalg.vector_norm(lvec, dim=-1, keepdim=True)
        ldir = lvec / (dist + 1e-12)
        att = LIT_LIGHT_INTENSITY / torch.clamp(dist ** 2, min=1e-12)
        n_dot_l = (n * ldir).sum(-1, keepdim=True).clamp(1e-3, 1.0)
        half = _unit(ldir + view)
        n_dot_h = (n * half).sum(-1, keepdim=True).clamp(0.0, 1.0)
        v_dot_h = (view * half).sum(-1, keepdim=True).clamp(0.0, 1.0)
        fresnel = f0 + (1.0 - f0) * (1.0 - v_dot_h) ** 5
        ggx_d = alpha ** 2 / (np.pi * (n_dot_h ** 2 * (alpha ** 2 - 1.0) + 1.0) ** 2)
        smith_vis = 0.5 / (
            n_dot_l * torch.sqrt(n_dot_v ** 2 * (1.0 - alpha ** 2) + alpha ** 2)
            + n_dot_v * torch.sqrt(n_dot_l ** 2 * (1.0 - alpha ** 2) + alpha ** 2))
        diffuse = (1.0 - fresnel) * c_diff / np.pi
        specular = fresnel * ggx_d * smith_vis
        color = color + att * n_dot_l * (diffuse + specular)
    return color.clamp(0.0, 1.0) ** (1.0 / 2.2)


def shade_depth(depth: torch.Tensor, background: float = 1e30) -> torch.Tensor:
    """Screen-space-normal lambertian shading of (B, H, W) depth maps ->
    (B, H, W) in [0, 1], 0 where background."""
    d = depth.to(torch.float32)
    fg = d < background
    dzdy, dzdx = torch.gradient(torch.where(fg, d, torch.nan), dim=(-2, -1))
    n = torch.stack([-torch.nan_to_num(dzdx), -torch.nan_to_num(dzdy),
                     torch.full_like(d, 0.02)], dim=-1)
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-9)
    light = torch.tensor([0.3, -0.5, 0.8], dtype=torch.float64)
    light = (light / torch.linalg.vector_norm(light)).to(torch.float32).to(d.device)
    shade = (n @ light).clamp(0.0, 1.0) * 0.8 + 0.2
    return torch.where(fg, shade, 0.0)


def vis_camera(cam_wp: torch.Tensor, img_wh: int):
    """(B, 3) weak-perspective cameras -> the vis renders' perspective
    camera: translations (B, 3) and intrinsics (3, 3), at the reference
    vis focal length of 5000 px at 512 px, scaled to `img_wh`."""
    focal = 5000.0 * img_wh / 512.0
    cam_t = weak_perspective_to_camera_translation(cam_wp.to(torch.float32), focal, img_wh)
    return cam_t, torch.as_tensor(get_intrinsics_matrix(img_wh, img_wh, focal),
                                  device=cam_wp.device)


def _vis_base(image, img_wh: int, dev) -> torch.Tensor:
    """One composite base: float32 in [0, 1] (divided by 255 when its
    largest value is above 1.5), grey replicated to RGB, resized to
    (img_wh, img_wh) with cv2's float INTER_LINEAR when its size differs."""
    base = torch.as_tensor(image, device=dev).to(torch.float32)
    if base.amax() > 1.5:
        base = base / 255.0
    if base.dim() == 2:
        base = base[..., None].expand(-1, -1, 3)
    if tuple(base.shape[:2]) != (img_wh, img_wh):
        base = cv2_resize_linear_f32(base, img_wh, img_wh)
    return base


def render_body_vis_batch(verts: torch.Tensor, cam_wp: torch.Tensor, assets,
                          img_wh: int = 512,
                          image: Optional[Union[torch.Tensor, Sequence]] = None,
                          rotate_x180: bool = False, style: str = "lit"
                          ) -> torch.Tensor:
    """Shaded renders of a batch of bodies from predicted vertices and
    weak-perspective cameras, in one face-id rasterisation.

    Args:
      verts: (B, V, 3); cam_wp: (B, 3) [s, tx, ty].
      image: None (white background), or images to composite over: a
        (B, H, W[, 3]) tensor or a sequence of B (H_i, W_i[, 3]) arrays of
        any sizes, each resized to the render's size (`_vis_base`).  The
        body replaces the pixels it covers, like the reference's
        `rend_img * valid_mask + (1 - valid_mask) * img`.
      rotate_x180: rotate the bodies 180 degrees about x first (the
        reference's reposed T-pose view).
      style: "lit" (the reference pyrender scene, `lit_face_colors`) or
        "parts" (body-part colours shaded by the depth's normals).
    Returns:
      (B, img_wh, img_wh, 3) uint8 on the bodies' device.
    """
    if style not in ("lit", "parts"):
        raise ValueError(f"unknown style {style!r}")
    dev = verts.device
    verts = verts.to(torch.float32)
    if rotate_x180:
        verts = verts * torch.tensor(_FLIP_YZ, device=dev)
    cam_t, K = vis_camera(cam_wp.to(dev), img_wh)
    fid, depth = render_face_ids(verts, cam_t, K, assets.faces, img_wh)
    if style == "lit":
        fg = fid >= 0
        face_rgb = lit_face_colors(verts, assets.faces)
        safe = fid.clamp(min=0).long()
        color = face_rgb[torch.arange(fid.shape[0], device=dev)[:, None, None], safe]
    else:
        parts = face_ids_to_parts(fid, assets.face_parts)
        fg = parts > 0
        part_colors = torch.as_tensor(PART_COLORS, device=dev)
        color = part_colors[parts.long()] * shade_depth(depth)[..., None]
    if image is None:
        base = torch.ones((), device=dev)
    else:
        base = torch.stack([_vis_base(im, img_wh, dev) for im in image])
    out = torch.where(fg[..., None], color, base)
    return (out.clamp(0.0, 1.0) * 255).to(torch.uint8)


def render_body_vis(verts: torch.Tensor, cam_wp: torch.Tensor, assets,
                    img_wh: int = 512, image: Optional[torch.Tensor] = None,
                    rotate_x180: bool = False, style: str = "lit") -> torch.Tensor:
    """One body: (V, 3) vertices, (3,) camera, optional (img_wh, img_wh[, 3])
    image -> (img_wh, img_wh, 3) uint8; `render_body_vis_batch` with B = 1."""
    return render_body_vis_batch(verts[None], cam_wp[None], assets, img_wh,
                                 None if image is None else image[None],
                                 rotate_x180, style)[0]


def proxy_vis_batch(proxies: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) proxies -> (B, H, W) uint8: silhouette + summed
    heatmaps clipped to [0, 1], through matplotlib's 'gray' mapping with
    each image's own min and max (what `plt.imsave(..., cmap="gray")`
    writes, with its float32 normalisation)."""
    img = (proxies[..., 0] + proxies[..., 1:].sum(dim=-1)).clamp(0.0, 1.0).to(torch.float32)
    vmin = img.flatten(1).amin(dim=1).view(-1, 1, 1).double()
    vmax = img.flatten(1).amax(dim=1).view(-1, 1, 1).double()
    t = (img.double() - vmin).to(torch.float32)
    t = (t.double() / torch.where(vmax > vmin, vmax - vmin, 1.0)).to(torch.float32)
    t = torch.where(vmax > vmin, t, 0.0)
    idx = torch.floor(t * 256).clamp(0, 255).long()
    return torch.as_tensor(_GRAY_LEVELS, device=img.device)[idx]


def proxy_vis(proxy: torch.Tensor, out_path: str) -> None:
    """Write one (H, W, C) proxy's `proxy_vis_batch` image as a PNG."""
    write_png(out_path, proxy_vis_batch(proxy[None])[0].cpu().numpy())


def silhouette_overlay_vis(images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """`cv2.addWeighted(image, 1, mask * 255, 0.5, 0)` with the mask as
    three channels (`predict_silhouette_pointrend.py:53-57`): uint8
    (..., H, W, 3) images and (..., H, W) masks (> 0.5 is in) -> uint8,
    rounded half to even and saturated as cv2 does."""
    m = (masks > 0.5).to(torch.float32)[..., None] * 255.0
    return torch.round(images.to(torch.float32) * 1.0 + m * 0.5 + 0.0).clamp(0, 255).to(
        torch.uint8)


def _circle_half_widths(radius: int) -> np.ndarray:
    """cv2's filled circle (`cv::circle`, thickness -1, LINE_8, no shift)
    as the half width of its horizontal span in each of its 2r+1 rows: its
    midpoint loop fills spans centred on the centre, so a row is covered
    where |dx| <= the largest half width drawn on it."""
    r = radius
    half = np.full(2 * r + 1, -1, np.int64)
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        for row, h in ((-dy, dx), (dy, dx), (-dx, dy), (dx, dy)):
            half[row + r] = max(half[row + r], h)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return half


KEYPOINT_RADIUS = 5
KEYPOINT_COLOR = (0, 255, 0)
LABEL_COLOR = (255, 0, 0)
# The joint-index labels "0"-"16" as cv2.putText draws them
# (FONT_HERSHEY_SIMPLEX, scale 0.5, thickness 1; cv2 5 draws every
# lineType antialiased): label j's alpha (0-255) at row offsets -11..0 and
# column offsets 0..17 from the text origin, (17, 12, 18) uint8, zlib and
# base64.  Derived from cv2: each label's pixels translate exactly with the
# integer origin, and clipping at an image edge only drops the pixels
# outside it.
_LABEL_ALPHA = np.frombuffer(zlib.decompress(base64.b64decode(
    "eNq1lmtoFFcUx29iXr6SarWYZE2qoEZXfBSVqBipNkXETWKrbm0qFRQNWptYDFGCLwSfBUFjSlU0aaH9EAtpq0bxQ9Rq"
    "EIyLJkgwZkXF+Mxmo6IN2ewcZ+/MnHvOFddP3g+X4cfuzP3POXPvT4jUtRVlEwQZkx8b/wF8R0h9+zhxFDoGIuhvHBFJ"
    "d4rgSyRuKBTLKtNgDZIpkCeujE+G9Ug+g4Ip50UKlCBxQemxJWIqLEMS0+lrixdbYLJ6+g6AnB3Bi2Q98dUA3X8PpYsW"
    "MWnxgo+kdQs4+LQRahnIDfhuc7Lu16SGWu0+4gMRt8fTcsXj+ViR30COJSLaSF5bUTyOglR/5+nA//MIORzIFAnN1wmp"
    "221Ou3pi+a1iLzVxEHPA4O8s9phRxEGVsUYHP/KbHIU6jzkGIEjssXLNjBZrUXlkrCakwufzNUGLtsKq4HhO9nXP5qA0"
    "vFhrhDA8OzmaoYxR3sbAQG0JuTAfr0dcnW7OXpirmq6tNc+98nZ7gvrDyH9C8OqMi90k3tVHjxazvEzrzSIA3r1Zr05x"
    "knCtxsvJngeDOfm8N1cwMuj+fsHJNrh2+fItuFGJJGerOf6CvYV8QYXaeoT4uvejqG2YsilSr0WEzIYms2IHCfFCX+1f"
    "JUH9Prvb95yq/oqSKqjdVGMcICTTbU6bYQzpusg0AdTjk0M/mfNS+puTXd9nfdvRSO7T//cgvKhJ4cV5u17DNmZy0Kfe"
    "r/VKeSibg+zQFu0z9UPP3cPk4xY/w/GFxc+aE9V38fwPc55Bdr8MWBUJ93qnWt7TX+TuSvaE7eHNkxa0ttDylLfB83/T"
    "+AKG8FzfyO+rlMCqm+YIGP209NfPaSDH3Mj5OOHXNpIM+fbp2PVSa5++HZXaT1YYY/VHn9XAxPA88b4x4oeKjdMomNN1"
    "q7ohXELImUvmR7s3GKfIzchivMYQ8lZfrMzK99fTDn9k7lkGrfPVewtdMy90pqvPFgrM+ZNetW1NeovE3biXl5p9/mU6"
    "eV0nQtDd4GYx4lzaHjG8+NCGUWx76npS1/6aNELc/YYBIvF0UL3psVAo97Ev1NuRHZUPOaqjGltHijTfQ9WHYkyz8SAM"
    "bEtImF4W/lM7Lc7d1Wq6oXcWB+ndW99bLzyXUTyccxnFA89lFA/nXGbiIQkTD0mYeEjCxEMSJh6SKPHAcxnFA8/lqOKB"
    "vuFcoG84F5gLL9A3qHh8oAvMhReYK6p4OHFQPJw4KB4YB8UD41DxUP7jiAcSFA+HKPGwCREPi6B4YBwUDydOdPGwcynx"
    "cHKheFA/tMSDlgnFwyFKPGxCxMP5jRIPYoO2eEiixMPJpcQDyxRVPJT32uJBvNcSD5LLFg+Vi4iHTYh4WISKhyRMPCRh"
    "4iGJEg/mvVI8WPu9UzzsXEo8nFwoHpgLxQNzUfGwCBUPi1DxsAgVD7vriHhIosQDc6F4YK6o4qHqZYuHqpctHqRetnio"
    "ehHxsAgVD4tQ8ZCEiYckTDys/RDFA3OheKh6vVM83gD+oPai"
)), np.uint8).reshape(17, 12, 18).copy()
_LABEL_TOP = -11


def _label_mask(labels: int, origins: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The alpha (int32, 0-255) of label `labels` drawn at each of the
    (B, 2) integer origins (x, y) in (B, H, W) images, clipped."""
    B = origins.shape[0]
    dev = origins.device
    table = torch.as_tensor(_LABEL_ALPHA[labels], device=dev).to(torch.int32)
    rows, cols = table.shape
    y = origins[:, 1, None, None] + _LABEL_TOP + torch.arange(rows, device=dev)[None, :, None]
    x = origins[:, 0, None, None] + torch.arange(cols, device=dev)[None, None, :]
    inside = (y >= 0) & (y < H) & (x >= 0) & (x < W) & (table > 0)
    flat = torch.arange(B, device=dev)[:, None, None] * (H * W) + y * W + x
    alpha = torch.zeros(B * H * W, dtype=torch.int32, device=dev)
    alpha[flat[inside]] = table.expand(B, -1, -1)[inside]
    return alpha.view(B, H, W)


def keypoints_vis(images: torch.Tensor, keypoints: torch.Tensor) -> torch.Tensor:
    """cv2's keypoint annotation of `predict_joints2D.py:53-59`: for each
    joint j in order a green filled circle of radius 5, then its index
    `str(j)` in red (cv2.putText, FONT_HERSHEY_SIMPLEX, scale 0.5) with the
    text origin at the centre, both clipped to the image; centres rounded
    half to even, as `int(round(x))`.  The text is blended as cv2 blends
    it: (pixel * (255 - a) + colour * a + 127) // 255 per channel.  A later
    joint's circle covers an earlier joint's text.  uint8 (B, H, W, 3)
    images, (B, J, >= 2) keypoints with J <= 17 -> uint8 (B, H, W, 3)."""
    B, H, W, _ = images.shape
    J = keypoints.shape[1]
    if J > len(_LABEL_ALPHA):
        raise ValueError(f"labels are drawn for at most {len(_LABEL_ALPHA)} joints, got {J}")
    dev = images.device
    r = KEYPOINT_RADIUS
    half = torch.as_tensor(_circle_half_widths(r), device=dev)
    c = torch.round(keypoints[..., :2].to(torch.float32)).to(torch.int64)     # (B, J, 2)
    dy = torch.arange(H, device=dev)[None, None, :] - c[..., 1:2]              # (B, J, H)
    dx = torch.arange(W, device=dev)[None, None, :] - c[..., 0:1]              # (B, J, W)
    row_half = torch.where(dy.abs() <= r, half[dy.clamp(-r, r) + r], -1)       # (B, J, H)
    green = torch.tensor(KEYPOINT_COLOR, dtype=torch.int32, device=dev)
    red = torch.tensor(LABEL_COLOR, dtype=torch.int32, device=dev)
    out = images.to(torch.int32)
    for j in range(J):
        circle = dx[:, j].abs()[:, None, :] <= row_half[:, j, :, None]         # (B, H, W)
        out = torch.where(circle[..., None], green, out)
        a = _label_mask(j, c[:, j], H, W)[..., None]
        out = (out * (255 - a) + red * a + 127) // 255
    return out.to(torch.uint8)


def apply_colormap(image: torch.Tensor, vmin: float, vmax: float) -> torch.Tensor:
    """matplotlib's viridis of a scalar image -> uint8 (..., 4) RGBA, as
    `plt.get_cmap("viridis")(x, bytes=True)` of the image clipped to
    [vmin, vmax] and scaled to [0, 1] in float64: entry trunc(x * 256), 1.0
    taking the last (`predict/predict_densepose.py:18-45`, without its
    random discrete colormap, which STRAPS never uses)."""
    lo, hi = float(vmin), float(vmax)
    t = (image.to(torch.float64).clamp(lo, hi) - lo) / max(hi - lo, 1e-12)
    idx = (t * 256).to(torch.int64).clamp(max=255)
    lut = torch.as_tensor(np.concatenate([_VIRIDIS, np.full((256, 1), 255, np.uint8)], 1),
                          device=image.device)
    return lut[idx]


def densepose_overlay_vis(images: torch.Tensor, i_images: torch.Tensor) -> torch.Tensor:
    """The DensePose part labels (0-24) in viridis, black on background,
    blended over the images by `cv2.addWeighted(image, 0.6, vis, 0.4, 0)`
    (`predict_densepose.py:105-115`): uint8 (..., H, W, 3) images and
    (..., H, W) labels -> uint8, float32 arithmetic rounded half to even
    and saturated as cv2 does."""
    vis = apply_colormap(i_images, vmin=0, vmax=24)[..., :3]
    vis = torch.where((i_images == 0)[..., None], 0, vis)
    return torch.round(images.to(torch.float32) * 0.6 + vis.to(torch.float32) * 0.4
                       + 0.0).clamp(0, 255).to(torch.uint8)
