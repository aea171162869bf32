"""Plain PyTorch forward of MASt3R (ViT-L encoder, two cross-attending
decoders, DPT + Cat-MLP heads), the benchmark's reference for the network.

Follows the published architecture (arXiv:2406.09756 on DUSt3R and CroCo
v2, checkpoint ``MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric``) and its
parameter names. Weights are a dict ``name -> tensor`` that the benchmark
makes from the seed (``param_specs`` lists them); nothing here imports the
program. Every matmul and convolution runs in float32 with TF32 off, on
operands first rounded by ``round_operand`` to the precision that ``prec``
gives for that part of the network (``"fp32"`` everywhere for the
reference; one step lower for the control).

Departures from the published model, each shared with the program under
test: the ``exp`` activations clamp their exponent at 20 (random weights
would otherwise give inf maps), and images are 384x512 with the published
16-pixel patches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EXP_CLAMP = 20.0
FP8_MAX = 448.0


def exact_fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- parameters ----------------------------------------------------------------


def _linear(name, dout, din, group):
    return [(name + ".weight", (dout, din), ("xavier", din, dout), group),
            (name + ".bias", (dout,), ("bias",), "fp32")]


def _norm(name, dim):
    return [(name + ".weight", (dim,), ("norm_w",), "fp32"),
            (name + ".bias", (dim,), ("bias",), "fp32")]


def _conv(name, dout, din, k, group, bias=True):
    out = [(name + ".weight", (dout, din, k, k), ("fan_in", din * k * k),
            group)]
    if bias:
        out.append((name + ".bias", (dout,), ("bias",), "fp32"))
    return out


def _conv_t(name, din, dout, k, group):
    return [(name + ".weight", (din, dout, k, k), ("fan_in", din * k * k),
             group),
            (name + ".bias", (dout,), ("bias",), "fp32")]


def param_specs(m):
    """(name, shape, init, group) of every parameter of the model with
    sizes ``m`` (the ``model`` dict of a configuration file). ``init``:
    ``("xavier", fan_in, fan_out)``, ``("fan_in", n)`` (uniform within
    1/sqrt(n)), ``("bias",)`` or ``("norm_w",)``; ``group``: ``trunk``,
    ``head``, ``head_last`` or ``fp32``, the storage class."""
    ed, dd, ps = m["enc_embed_dim"], m["dec_embed_dim"], m["patch_size"]
    hid_e, hid_d = m["mlp_ratio"] * ed, m["mlp_ratio"] * dd
    specs = [("patch_embed.proj.weight", (ed, 3, ps, ps),
              ("xavier", 3 * ps * ps, ed), "trunk"),
             ("patch_embed.proj.bias", (ed,), ("bias",), "fp32")]
    for i in range(m["enc_depth"]):
        p = f"enc_blocks.{i}."
        specs += (_norm(p + "norm1", ed) + _linear(p + "attn.qkv", 3 * ed, ed,
                                                    "trunk")
                  + _linear(p + "attn.proj", ed, ed, "trunk")
                  + _norm(p + "norm2", ed)
                  + _linear(p + "mlp.fc1", hid_e, ed, "trunk")
                  + _linear(p + "mlp.fc2", ed, hid_e, "trunk"))
    specs += _norm("enc_norm", ed)
    specs += _linear("decoder_embed", dd, ed, "trunk")
    for stream in ("dec_blocks", "dec_blocks2"):
        for i in range(m["dec_depth"]):
            p = f"{stream}.{i}."
            specs += (_norm(p + "norm1", dd)
                      + _linear(p + "attn.qkv", 3 * dd, dd, "trunk")
                      + _linear(p + "attn.proj", dd, dd, "trunk"))
            for part in ("projq", "projk", "projv", "proj"):
                specs += _linear(p + "cross_attn." + part, dd, dd, "trunk")
            specs += (_norm(p + "norm2", dd) + _norm(p + "norm3", dd)
                      + _norm(p + "norm_y", dd)
                      + _linear(p + "mlp.fc1", hid_d, dd, "trunk")
                      + _linear(p + "mlp.fc2", dd, hid_d, "trunk"))
    specs += _norm("dec_norm", dd)
    ld, fd = m["layer_dims"], m["feature_dim"]
    idim = ed + dd
    for h in ("downstream_head1", "downstream_head2"):
        p = h + ".dpt."
        dims_in = [ed, dd, dd, dd]
        specs += _conv(p + "act_postprocess.0.0", ld[0], dims_in[0], 1, "head")
        specs += _conv_t(p + "act_postprocess.0.1", ld[0], ld[0], 4, "head")
        specs += _conv(p + "act_postprocess.1.0", ld[1], dims_in[1], 1, "head")
        specs += _conv_t(p + "act_postprocess.1.1", ld[1], ld[1], 2, "head")
        specs += _conv(p + "act_postprocess.2.0", ld[2], dims_in[2], 1, "head")
        specs += _conv(p + "act_postprocess.3.0", ld[3], dims_in[3], 1, "head")
        specs += _conv(p + "act_postprocess.3.1", ld[3], ld[3], 3, "head")
        for i in range(4):
            specs += _conv(p + f"scratch.layer{i + 1}_rn", fd, ld[i], 3,
                           "head", bias=False)
        for i in range(1, 5):
            r = p + f"scratch.refinenet{i}."
            for u in ("resConfUnit1", "resConfUnit2"):
                specs += _conv(r + u + ".conv1", fd, fd, 3, "head")
                specs += _conv(r + u + ".conv2", fd, fd, 3, "head")
            specs += _conv(r + "out_conv", fd, fd, 1, "head")
        specs += _conv(p + "head.0", fd // 2, fd, 3, "head")
        specs += _conv(p + "head.2", m["last_dim"], fd // 2, 3, "head")
        specs += _conv(p + "head.4", 4, m["last_dim"], 1, "head_last")
        q = h + ".head_local_features."
        specs += _linear(q + "fc1", 4 * idim, idim, "head")
        specs += _linear(q + "fc2", (m["desc_dim"] + 1) * ps * ps, 4 * idim,
                         "head")
    return specs


def init_bound(init):
    """Half-width of the uniform draw of a weight (the published
    initializers: xavier for linears and the patch embedding, 1/sqrt(fan_in)
    for convolutions)."""
    if init[0] == "xavier":
        return math.sqrt(6.0 / (init[1] + init[2]))
    if init[0] == "fan_in":
        return math.sqrt(1.0 / init[1])
    raise ValueError(init)


# -- precision -----------------------------------------------------------------


def round_operand(x, kind):
    """``x`` (float32) rounded to ``kind``: ``fp32`` (unchanged), ``tf32``
    (10 mantissa bits, round to nearest even), ``bf16``, or ``fp8`` (e4m3
    with one scale for the tensor, its largest magnitude mapped to 448)."""
    if kind == "fp32":
        return x
    if kind == "bf16":
        return x.to(torch.bfloat16).float()
    if kind == "tf32":
        i = x.contiguous().view(torch.int32)
        lsb = (i >> 13) & 1
        i = (i + 0xFFF + lsb) & ~0x1FFF
        return i.view(torch.float32)
    if kind == "fp8":
        amax = x.abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale
    raise ValueError(kind)


class Net:
    """The weights (float32 views of the benchmark's tensors) and the
    operand precision of each part: ``prec`` maps ``trunk`` (the
    transformer's linears), ``attn`` (the attention products) and ``head``
    (the heads' linears and convolutions) to a ``round_operand`` kind."""

    def __init__(self, weights, m, prec=None):
        self.w = {k: v.float() for k, v in weights.items()}
        self.m = m
        self.prec = {"trunk": "fp32", "attn": "fp32", "head": "fp32"}
        self.prec.update(prec or {})

    def _r(self, x, part):
        return round_operand(x, self.prec[part])

    def linear(self, x, name, part):
        w, b = self.w[name + ".weight"], self.w.get(name + ".bias")
        y = F.linear(self._r(x, part), self._r(w, part))
        return y if b is None else y + b

    def conv(self, x, name, stride=1, padding=None):
        w, b = self.w[name + ".weight"], self.w.get(name + ".bias")
        if padding is None:
            padding = w.shape[-1] // 2
        return F.conv2d(self._r(x, "head"), self._r(w, "head"), b,
                        stride=stride, padding=padding)

    def conv_t(self, x, name, stride):
        w, b = self.w[name + ".weight"], self.w[name + ".bias"]
        return F.conv_transpose2d(self._r(x, "head"), self._r(w, "head"), b,
                                  stride=stride)

    def norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"],
                            self.w[name + ".bias"], 1e-6)

    # -- transformer -----------------------------------------------------------

    def rope(self, x, pos, base):
        """CroCo's RoPE2D: the head dim's first half turns with the
        token's row, the second with its column; ``rotate_half`` pairs
        feature i with i + d/4."""
        d = x.shape[-1]
        half = d // 2
        inv = 1.0 / (base ** (torch.arange(0, half, 2, dtype=torch.float32,
                                           device=x.device) / half))
        out = []
        for c, t in ((0, x[..., :half]), (1, x[..., half:])):
            ang = pos[..., c].float()[:, None, :, None] * inv
            ang = torch.cat([ang, ang], dim=-1)
            q = half // 2
            rot = torch.cat([-t[..., q:], t[..., :q]], dim=-1)
            out.append(t * torch.cos(ang) + rot * torch.sin(ang))
        return torch.cat(out, dim=-1)

    def attention(self, q, k, v):
        d = q.shape[-1]
        a = torch.matmul(self._r(q, "attn"), self._r(k, "attn").transpose(-1, -2))
        p = torch.softmax(a * d ** -0.5, dim=-1)
        return torch.matmul(self._r(p, "attn"), self._r(v, "attn"))

    def _heads(self, x, nh):
        b, n, c = x.shape
        return x.reshape(b, n, nh, c // nh).transpose(1, 2)

    def _merge(self, x):
        b, h, n, d = x.shape
        return x.transpose(1, 2).reshape(b, n, h * d)

    def self_attn(self, x, pos, name, nh):
        qkv = self.linear(x, name + ".qkv", "trunk")
        b, n, _ = qkv.shape
        qkv = qkv.reshape(b, n, 3, nh, -1).permute(2, 0, 3, 1, 4)
        base = self.m["rope_base"]
        q, k = self.rope(qkv[0], pos, base), self.rope(qkv[1], pos, base)
        out = self._merge(self.attention(q, k, qkv[2]))
        return self.linear(out, name + ".proj", "trunk")

    def cross_attn(self, x, y, xpos, ypos, name, nh):
        base = self.m["rope_base"]
        q = self.rope(self._heads(self.linear(x, name + ".projq", "trunk"),
                                  nh), xpos, base)
        k = self.rope(self._heads(self.linear(y, name + ".projk", "trunk"),
                                  nh), ypos, base)
        v = self._heads(self.linear(y, name + ".projv", "trunk"), nh)
        out = self._merge(self.attention(q, k, v))
        return self.linear(out, name + ".proj", "trunk")

    def mlp(self, x, name, part="trunk"):
        h = F.gelu(self.linear(x, name + ".fc1", part))
        return self.linear(h, name + ".fc2", part)

    def positions(self, b, device):
        ps = self.m["patch_size"]
        h, w = self.m["img_size"]
        nh, nw = h // ps, w // ps
        ys = torch.arange(nh, device=device).repeat_interleave(nw)
        xs = torch.arange(nw, device=device).repeat(nh)
        return torch.stack([ys, xs], -1).expand(b, nh * nw, 2)

    def encode(self, img_u8):
        """(b, h, w, 3) uint8 -> encoder tokens (b, n, enc_embed_dim)."""
        m = self.m
        x = (img_u8.float() / 255.0 - 0.5) / 0.5
        b, h, w, c = x.shape
        ps = m["patch_size"]
        nh, nw = h // ps, w // ps
        x = x.reshape(b, nh, ps, nw, ps, c).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, nh * nw, c * ps * ps)
        wgt = self.w["patch_embed.proj.weight"].reshape(m["enc_embed_dim"], -1)
        x = (F.linear(self._r(x, "trunk"), self._r(wgt, "trunk"))
             + self.w["patch_embed.proj.bias"])
        pos = self.positions(b, x.device)
        for i in range(m["enc_depth"]):
            p = f"enc_blocks.{i}."
            x = x + self.self_attn(self.norm(x, p + "norm1"), pos,
                                   p + "attn", m["enc_num_heads"])
            x = x + self.mlp(self.norm(x, p + "norm2"), p + "mlp")
        return self.norm(x, "enc_norm")

    def decode_pair(self, f1, f2):
        """Encoder tokens of views 1 and 2, (b, n, E) each -> (res1, res2),
        dicts of NHWC ``pts3d``, ``conf``, ``desc``, ``desc_conf``."""
        m = self.m
        nh = m["dec_num_heads"]
        pos = self.positions(f1.shape[0], f1.device)
        out1, out2 = [f1], [f2]
        x1 = self.linear(f1, "decoder_embed", "trunk")
        x2 = self.linear(f2, "decoder_embed", "trunk")
        for i in range(m["dec_depth"]):
            y1 = self._dec_block(x1, x2, pos, f"dec_blocks.{i}.", nh)
            y2 = self._dec_block(x2, x1, pos, f"dec_blocks2.{i}.", nh)
            x1, x2 = y1, y2
            out1.append(x1)
            out2.append(x2)
        out1[-1] = self.norm(out1[-1], "dec_norm")
        out2[-1] = self.norm(out2[-1], "dec_norm")
        return (self.head(out1, "downstream_head1"),
                self.head(out2, "downstream_head2"))

    def _dec_block(self, x, y, pos, p, nh):
        x = x + self.self_attn(self.norm(x, p + "norm1"), pos, p + "attn", nh)
        y_ = self.norm(y, p + "norm_y")
        x = x + self.cross_attn(self.norm(x, p + "norm2"), y_, pos, pos,
                                p + "cross_attn", nh)
        return x + self.mlp(self.norm(x, p + "norm3"), p + "mlp")

    # -- heads -----------------------------------------------------------------

    def _rcu(self, x, p):
        out = self.conv(F.relu(x), p + ".conv1")
        out = self.conv(F.relu(out), p + ".conv2")
        return out + x

    def _fusion(self, x, p, res=None):
        if res is not None:
            x = x + self._rcu(res, p + "resConfUnit1")
        x = self._rcu(x, p + "resConfUnit2")
        h, w = x.shape[-2:]
        x = F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear",
                          align_corners=True)
        return self.conv(x, p + "out_conv")

    def dpt(self, tokens, p):
        m = self.m
        ps = m["patch_size"]
        nh, nw = m["img_size"][0] // ps, m["img_size"][1] // ps
        L = m["dec_depth"]
        hooks = (0, L * 2 // 4, L * 3 // 4, L)
        maps = []
        for h in hooks:
            t = tokens[h]
            maps.append(t.reshape(t.shape[0], nh, nw, -1).permute(0, 3, 1, 2))
        a = p + "act_postprocess."
        l0 = self.conv_t(self.conv(maps[0], a + "0.0"), a + "0.1", 4)
        l1 = self.conv_t(self.conv(maps[1], a + "1.0"), a + "1.1", 2)
        l2 = self.conv(maps[2], a + "2.0")
        l3 = self.conv(self.conv(maps[3], a + "3.0"), a + "3.1", stride=2,
                       padding=1)
        s = p + "scratch."
        l0 = self.conv(l0, s + "layer1_rn")
        l1 = self.conv(l1, s + "layer2_rn")
        l2 = self.conv(l2, s + "layer3_rn")
        l3 = self.conv(l3, s + "layer4_rn")
        p4 = self._fusion(l3, s + "refinenet4.")[:, :, :l2.shape[2],
                                                  :l2.shape[3]]
        p3 = self._fusion(p4, s + "refinenet3.", l2)
        p2 = self._fusion(p3, s + "refinenet2.", l1)
        p1 = self._fusion(p2, s + "refinenet1.", l0)
        x = self.conv(p1, p + "head.0")
        h, w = x.shape[-2:]
        x = F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear",
                          align_corners=True)
        x = F.relu(self.conv(x, p + "head.2"))
        return self.conv(x, p + "head.4")

    def head(self, tokens, name):
        m = self.m
        ps, dd = m["patch_size"], m["desc_dim"]
        nh, nw = m["img_size"][0] // ps, m["img_size"][1] // ps
        dpt_out = self.dpt(tokens, name + ".dpt.")
        cat = torch.cat([tokens[0], tokens[-1]], dim=-1)
        local = self.mlp(cat, name + ".head_local_features", "head")
        b = local.shape[0]
        local = local.reshape(b, nh, nw, -1).permute(0, 3, 1, 2)
        local = F.pixel_shuffle(local, ps)
        fmap = torch.cat([dpt_out, local], dim=1).permute(0, 2, 3, 1)
        xyz = fmap[..., 0:3]
        d = xyz.norm(dim=-1, keepdim=True)
        pts3d = xyz / d.clamp(min=1e-8) * torch.expm1(d.clamp(max=EXP_CLAMP))
        conf = 1.0 + torch.exp(fmap[..., 3].clamp(max=EXP_CLAMP))
        desc = fmap[..., 4:4 + dd]
        desc = desc / desc.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        desc_conf = torch.exp(fmap[..., 4 + dd].clamp(max=EXP_CLAMP))
        return {"pts3d": pts3d, "conf": conf, "desc": desc,
                "desc_conf": desc_conf}
