"""Counter-based RNG for the transport loop: Threefry-2x32, bit-exact with
soc_tpu.rng.

Every photon packet owns the stream ``(seed, hi, stream)`` and advances a
private draw counter, so a packet's random numbers do not depend on how
packets are batched or which device runs them.

Torch has no usable uint32 arithmetic (shifts on ``torch.uint32`` are not
implemented on the CPU, and CUDA's coverage is no better), so every 32-bit
word is held in an int64 tensor and masked with 0xFFFFFFFF after each add
and rotate. The results are the same bits soc_tpu computes in uint32, on
the CPU and on the card.
"""

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def u32(x, like):
    """A Python int or a tensor -> int64 tensor of 32-bit words on the
    device of ``like``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.full(like.shape, int(x) & MASK32, dtype=torch.int64,
                      device=like.device)


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k0, k1, c0, c1, rounds=13):
    """Threefry-2x32 over int64-held uint32 words; returns (x0, x1).

    k0 may be a Python int (the run seed); k1, c0, c1 are tensors of one
    shape (or k1 a Python int)."""
    like = c0 if isinstance(c0, torch.Tensor) else c1
    k0 = u32(k0, like)
    k1 = u32(k1, like)
    x0 = u32(c0, like)
    x1 = u32(c1, like)
    ks2 = k0 ^ k1 ^ _PARITY
    keys = (k0, k1, ks2)

    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    done = 0
    r = 0
    while done < rounds:
        rots = _ROTATIONS[r % 2]
        for d in rots[: rounds - done]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, d)
            x1 = x1 ^ x0
        done += min(4, rounds - done)
        # key injection every 4 rounds (and after a final partial block)
        x0 = (x0 + keys[(r + 1) % 3]) & MASK32
        x1 = (x1 + keys[(r + 2) % 3] + (r + 1)) & MASK32
        r += 1
    return x0, x1


def _bits_to_unit(bits):
    """uint32 word -> float32 uniform in (0, 1]; int64 -> float32 rounds to
    nearest like the uint32 -> float32 conversion of soc_tpu."""
    u = bits.to(torch.float32) * (1.0 / 4294967296.0)
    return torch.clamp_min(u, 1e-12)


def _slot(counter):
    return (u32(counter, counter) * 2) & MASK32


def uniform2(seed, stream, counter, hi=0):
    """Two uniform(0,1) float32 draws for (seed, hi, stream, counter)."""
    b0, b1 = threefry2x32(seed, hi, stream, _slot(counter))
    return _bits_to_unit(b0), _bits_to_unit(b1)


def uniform4(seed, stream, counter, hi=0):
    """Four uniform(0,1) float32 draws (two threefry evaluations)."""
    c1 = _slot(counter)
    b0, b1 = threefry2x32(seed, hi, stream, c1)
    b2, b3 = threefry2x32(seed, hi, stream, (c1 + 1) & MASK32)
    return (_bits_to_unit(b0), _bits_to_unit(b1), _bits_to_unit(b2),
            _bits_to_unit(b3))


def uniform1(seed, stream, counter, hi=0):
    """One uniform(0,1) float32 draw (slot 2*counter)."""
    b0, _ = threefry2x32(seed, hi, stream, _slot(counter))
    return _bits_to_unit(b0)


def step_uniforms(seed, stream, counter, hi):
    """(u_fp, u_bin, u_phi) from one threefry evaluation: the free-path draw
    keeps 32 bits, the phase-function bin and the azimuth 16 bits each."""
    b0, b1 = threefry2x32(seed, hi, stream, _slot(counter))
    u_fp = _bits_to_unit(b0)
    u_bin = (b1 >> 16).to(torch.float32) * (1.0 / 65536.0)
    u_phi = (b1 & 0xFFFF).to(torch.float32) * (1.0 / 65536.0)
    return u_fp, u_bin, u_phi


def step_uniforms4(seed, stream, counter, hi):
    """step_uniforms plus a fourth draw (the WITH_MSF species roulette)
    from a second evaluation at the odd slot; the first three values are
    step_uniforms' own."""
    c1 = _slot(counter)
    b0, b1 = threefry2x32(seed, hi, stream, c1)
    b2, _ = threefry2x32(seed, hi, stream, (c1 + 1) & MASK32)
    u_fp = _bits_to_unit(b0)
    u_bin = (b1 >> 16).to(torch.float32) * (1.0 / 65536.0)
    u_phi = (b1 & 0xFFFF).to(torch.float32) * (1.0 / 65536.0)
    return u_fp, u_bin, u_phi, _bits_to_unit(b2)
