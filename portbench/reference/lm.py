"""The plain reference of the models the cells run, in float32 PyTorch.

It imports nothing of the program.  It reads weights by the program's leaf
names from a dict the benchmark made, and works everything else out from
the equations:

- Mamba-2 layer (arXiv:2405.21060, the state-space dual form): RMSNorm;
  z, x, B, C, dt projections; depthwise causal conv over [x, B, C] then
  SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log); the selective scan
  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t, computed here
  in chunks of ``CHUNK`` positions as the quadratic form within a chunk and
  the state recurrence between chunks; y * SiLU(z), a gated RMSNorm over
  the heads' channels, the out projection; residual.  As the program's
  model, the layer has no D skip and no conv bias, and its groups of B / C
  are repeated over the heads.
- zamba2's shared block (arXiv:2411.15242, as the program builds it): a
  pre-norm causal attention layer (rotary positions, theta 10 000, the
  halves rotated) and a SwiGLU MLP, one set of weights applied after every
  ``attn_every`` Mamba-2 layers, then the tail layers.
- final RMSNorm, untied ``lm_head`` over the padded vocabulary, a linear
  ``value_head``.

``prec="fp8"`` is the control: every projection's two operands rounded to
float8 e4m3 with a scale a tensor (straight-through in the backward), the
rest as in float32.  TF32 is switched off while the reference runs.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

F32 = torch.float32
CHUNK = 64
EPS = 1e-6
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(t):
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return t + (q - t).detach()


def rmsnorm(x, scale):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS) \
        * scale.to(F32)


class RefLM:
    """The forward of ``cfg`` (the program's configuration fields) over
    whole sequences.  ``w``: {leaf name: tensor}; bf16 leaves are raised to
    float32 where they are used, one layer at a time."""

    def __init__(self, cfg: dict, w: dict, prec: str = "f32"):
        if cfg["family"] not in ("ssm", "hybrid"):
            raise ValueError(f"reference: family {cfg['family']!r} is not "
                             "written here")
        for k in ("window", "softcap_attn", "softcap_logits"):
            if cfg.get(k) is not None:
                raise ValueError(f"reference: {k} is not written here")
        if cfg.get("post_norm"):
            raise ValueError("reference: post_norm is not written here")
        self.c, self.w, self.prec = cfg, w, prec

    # -- pieces ---------------------------------------------------------------
    def p(self, name):
        return self.w[name].to(F32)

    def mm(self, x, name):
        """x (..., K) @ leaf ``name`` seen as (K, -1)."""
        w = self.p(name)
        w = w.reshape(x.shape[-1], -1)
        if self.prec == "fp8":
            x, w = _fp8(x), _fp8(w)
        return x @ w

    def ssd(self, x, dt, A, Bm, Cm):
        """x (B,T,H,P), dt (B,T,H), A (H,), Bm/Cm (B,T,G,N) -> (B,T,H,P)."""
        B_, T, H, P = x.shape
        rep = H // Bm.shape[2]
        Bh = Bm.repeat_interleave(rep, dim=2)
        Ch = Cm.repeat_interleave(rep, dim=2)
        pad = (-T) % CHUNK
        if pad:
            x, Bh, Ch = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bh, Ch))
            dt = F.pad(dt, (0, 0, 0, pad))
        nc = (T + pad) // CHUNK

        def ch(t):
            return t.reshape(B_, nc, CHUNK, *t.shape[2:])

        x, dt, Bh, Ch = ch(x), ch(dt), ch(Bh), ch(Ch)
        acum = torch.cumsum(dt * A, dim=2)                      # (B,c,Q,H)
        seg = acum[:, :, :, None, :] - acum[:, :, None, :, :]   # (B,c,i,j,H)
        causal = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                            device=x.device).tril()[None, None, :, :, None]
        L = torch.exp(torch.where(causal, seg, float("-inf")))
        cb = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
        y = torch.einsum("bcijh,bcjhp->bcihp", L * cb * dt[:, :, None], x)
        decay = torch.exp(acum[:, :, -1:, :] - acum) * dt       # (B,c,Q,H)
        states = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", Bh, decay, x)
        s = torch.zeros_like(states[:, 0])
        incoming = []
        for c in range(nc):
            incoming.append(s)
            s = s * torch.exp(acum[:, c, -1, :])[..., None, None] \
                + states[:, c]
        s_in = torch.stack(incoming, dim=1)                     # (B,c,H,P,N)
        y = y + torch.einsum("bcihn,bchpn->bcihp", Ch, s_in) \
            * torch.exp(acum)[..., None]
        return y.reshape(B_, nc * CHUNK, H, P)[:, :T]

    def mamba(self, x, pre):
        c = self.c
        B_, T, D = x.shape
        P, N, G = c["ssm_headdim"], c["d_state"], c.get("ssm_n_groups", 1)
        H = c.get("ssm_expand", 2) * D // P
        h = rmsnorm(x, self.p(pre + "norm.scale"))
        s = pre + "ssd."
        z = self.mm(h, s + "wz")
        xbc = torch.cat([self.mm(h, s + "wx"), self.mm(h, s + "wB"),
                         self.mm(h, s + "wC")], dim=-1)
        K = c.get("conv_kernel", 4)
        conv_w = self.p(s + "conv_w")                           # (K, C)
        xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (K - 1, 0)),
                       conv_w.t()[:, None, :], groups=xbc.shape[-1])
        xbc = F.silu(xbc.transpose(1, 2))
        xs = xbc[..., :H * P].reshape(B_, T, H, P)
        Bm = xbc[..., H * P:H * P + G * N].reshape(B_, T, G, N)
        Cm = xbc[..., H * P + G * N:].reshape(B_, T, G, N)
        dt = F.softplus(self.mm(h, s + "wdt") + self.p(s + "dt_bias"))
        A = -torch.exp(self.p(s + "A_log"))
        y = self.ssd(xs, dt, A, Bm, Cm).reshape(B_, T, H * P) * F.silu(z)
        y = rmsnorm(y, self.p(s + "norm_scale"))
        return x + self.mm(y, s + "out_proj")

    def attention_block(self, x, pre):
        c = self.c
        B_, T, _ = x.shape
        H, Hkv, dh = c["n_heads"], c["n_kv_heads"], c["d_head"]
        h = rmsnorm(x, self.p(pre + "attn_norm.scale"))
        a = pre + "attn."
        q = self.mm(h, a + "wq").reshape(B_, T, H, dh)
        k = self.mm(h, a + "wk").reshape(B_, T, Hkv, dh)
        v = self.mm(h, a + "wv").reshape(B_, T, Hkv, dh)
        pos = torch.arange(T, device=x.device, dtype=F32)
        inv = 1.0 / (c.get("rope_theta", 10_000.0) ** (
            torch.arange(0, dh, 2, device=x.device, dtype=F32) / dh))
        ang = pos[:, None] * inv[None, :]
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]

        def rope(t):
            t1, t2 = t[..., :dh // 2], t[..., dh // 2:]
            return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], -1)

        q, k = rope(q), rope(k)
        if Hkv != H:
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B_, T, H * dh)
        x = x + self.mm(o, a + "wo")
        h = rmsnorm(x, self.p(pre + "mlp_norm.scale"))
        m = pre + "mlp."
        g = F.silu(self.mm(h, m + "wg")) * self.mm(h, m + "wi")
        return x + self.mm(g, m + "wd")

    # -- the model ------------------------------------------------------------
    def blocks(self):
        """[(function, leaf prefix)] in the order the layers run."""
        c, L = self.c, self.c["n_layers"]
        if c["family"] == "ssm":
            return [(self.mamba, f"layers.{i}.") for i in range(L)]
        per = c["attn_every"]
        out = []
        for i in range(L // per):
            out += [(self.mamba, f"layers.{i * per + j}.")
                    for j in range(per)]
            out.append((self.attention_block, "shared_attn."))
        out += [(self.mamba, f"tail_blocks.{t}.") for t in range(L % per)]
        return out

    def embed(self, tokens):
        return self.w["tok_embed"].index_select(
            0, tokens.reshape(-1).long()).to(F32).reshape(*tokens.shape, -1)

    def hidden(self, tokens, checkpoint: bool = False):
        """tokens (B, T) -> final-normed hidden (B, T, D) f32; with
        ``checkpoint`` each block's activations are recomputed in the
        backward (torch.utils.checkpoint), so a training step fits."""
        x = self.embed(tokens)
        for fn, pre in self.blocks():
            if checkpoint and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(fn, x, pre,
                                                      use_reentrant=False)
            else:
                x = fn(x, pre)
        return self.final(x)

    def final(self, x):
        return rmsnorm(x, self.p("final_norm.scale"))

    def logits(self, hidden):
        return self.mm(hidden, "lm_head")

    def value(self, hidden):
        return (hidden @ self.p("value_head"))[..., 0]
