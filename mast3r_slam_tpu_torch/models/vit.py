"""ViT-L encoder and the dual cross-attention decoder.

Counterpart of ``mast3r_slam_tpu/models/vit.py``. Module names follow the
reference checkpoint (``enc_blocks.i.attn.qkv``, ``dec_blocks``/
``dec_blocks2``, ...). Attention is plain PyTorch, as the JAX package
writes it (``vit.py:37-45``): matmul, fp32 logits and softmax, matmul. The
projections return fp32 (as JAX's ``linear`` does), so q, k and v are fp32.
The rotary embedding of q and k and their cast to v's dtype are one call of
``rope.rope_qk`` (a hand-written kernel on the GPU) per attention.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Mlp, layernorm, linear
from .rope import rope_qk, rope_tables


def _split_heads(x, num_heads):
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _sdpa(q, k, v):
    """Softmax attention: fp32 logits and softmax, operand dtype kept."""
    d = q.shape[-1]
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * (d ** -0.5)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).float().to(v.dtype)


class Attention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def run(self, x, xrope, num_heads, dtype):
        qkv = linear(self.qkv, x, dtype)
        b, n, c3 = qkv.shape
        c = c3 // 3
        qkv = qkv.reshape(b, n, 3, num_heads, c // num_heads)
        q = qkv[:, :, 0].transpose(1, 2)
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        q, k = rope_qk(q, k, xrope, xrope, v.dtype)
        out = _merge_heads(_sdpa(q, k, v))
        return linear(self.proj, out, dtype)


class CrossAttention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def run(self, q_in, kv_in, qrope, krope, num_heads, dtype):
        q = _split_heads(linear(self.projq, q_in, dtype), num_heads)
        k = _split_heads(linear(self.projk, kv_in, dtype), num_heads)
        v = _split_heads(linear(self.projv, kv_in, dtype), num_heads)
        q, k = rope_qk(q, k, qrope, krope, v.dtype)
        out = _merge_heads(_sdpa(q, k, v))
        return linear(self.proj, out, dtype)


class EncoderBlock(nn.Module):
    def __init__(self, dim, mlp_ratio):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def run(self, x, xrope, num_heads, dtype):
        x = x + self.attn.run(layernorm(self.norm1, x), xrope, num_heads,
                              dtype).to(x.dtype)
        x = x + self.mlp.run(layernorm(self.norm2, x), dtype).to(x.dtype)
        return x


class DecoderBlock(nn.Module):
    """Self-attn + cross-attn into memory y + MLP (pre-norm)."""

    def __init__(self, dim, mlp_ratio):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim)
        self.cross_attn = CrossAttention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.norm_y = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def run(self, x, y, xrope, yrope, num_heads, dtype):
        x = x + self.attn.run(layernorm(self.norm1, x), xrope, num_heads,
                              dtype).to(x.dtype)
        y_ = layernorm(self.norm_y, y)
        x = x + self.cross_attn.run(layernorm(self.norm2, x), y_, xrope,
                                    yrope, num_heads, dtype).to(x.dtype)
        x = x + self.mlp.run(layernorm(self.norm3, x), dtype).to(x.dtype)
        return x


class PatchEmbed(nn.Module):
    """16x16 patchify; the weight is the reference's stride-16 conv
    (OIHW), applied as one matmul over flattened (c, ph, pw) patches."""

    def __init__(self, patch_size, dim):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, dim, patch_size, patch_size)

    def run(self, img, dtype):
        """img (b, h, w, 3) NHWC -> (tokens (b, n, c) fp32, pos (b, n, 2)
        int64 (y, x), grid (nh, nw))."""
        b, h, w, c = img.shape
        ps = self.patch_size
        nh, nw = h // ps, w // ps
        x = img.reshape(b, nh, ps, nw, ps, c).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, nh * nw, c * ps * ps)
        wgt = self.proj.weight.reshape(self.proj.weight.shape[0], -1)
        y = torch.matmul(x.to(dtype), wgt.to(dtype).t()).float()
        y = y + self.proj.bias.float()
        dev = img.device
        ys = torch.arange(nh, device=dev).repeat_interleave(nw)
        xs = torch.arange(nw, device=dev).repeat(nh)
        pos = torch.stack([ys, xs], dim=-1).expand(b, nh * nw, 2)
        return y, pos, (nh, nw)


def encode(model, img, cfg, dtype):
    """Patchify + encoder blocks + final norm (``vit.py:112``)."""
    x, pos, grid = model.patch_embed.run(img, dtype)
    x = x.to(dtype)
    # q and k are fp32 (linear returns fp32), so are the RoPE tables
    rope = rope_tables(pos, cfg.enc_embed_dim // cfg.enc_num_heads,
                       cfg.rope_base, torch.float32)
    for blk in model.enc_blocks:
        x = blk.run(x, rope, cfg.enc_num_heads, dtype)
    x = layernorm(model.enc_norm, x)
    return x, pos, grid


def decode(model, f1, pos1, f2, pos2, cfg, dtype):
    """Two weight-distinct decoder streams, each block reading the other
    stream's previous output as memory (``vit.py:125``). Returns the hook
    lists [encoder tokens, block 1 .. block L (last one normed)]."""
    out1, out2 = [f1], [f2]
    x1 = linear(model.decoder_embed, f1, dtype).to(dtype)
    x2 = linear(model.decoder_embed, f2, dtype).to(dtype)
    hd = cfg.dec_embed_dim // cfg.dec_num_heads
    rope1 = rope_tables(pos1, hd, cfg.rope_base, torch.float32)
    rope2 = rope_tables(pos2, hd, cfg.rope_base, torch.float32)
    for blk1, blk2 in zip(model.dec_blocks, model.dec_blocks2):
        y1 = blk1.run(x1, x2, rope1, rope2, cfg.dec_num_heads, dtype)
        y2 = blk2.run(x2, x1, rope2, rope1, cfg.dec_num_heads, dtype)
        x1, x2 = y1, y2
        out1.append(x1)
        out2.append(x2)
    out1[-1] = layernorm(model.dec_norm, out1[-1])
    out2[-1] = layernorm(model.dec_norm, out2[-1])
    return out1, out2
