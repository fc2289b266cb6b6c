"""TurboQuant block compression: shared core + lossy checkpoints (numpy
only; a copy of the JAX package's storage/turboquant.py, so the rotation,
the codes and the files are the same in both packages).

* A block of D = 2^p complex amplitudes is one row of a (B, 2D) real
  matrix ([re_0..re_{D-1}, im_0..im_{D-1}] concatenated planes), so the
  decorrelating rotation is one batched (B, 2D) @ (2D, 2D) product.
* One rotation matrix, drawn from a PCG64 seed, is shared by every
  block; files store the seed, never the matrix.
* Quantization is symmetric b-bit against a per-block max-abs scale.
* Dequantize(codes, scales) is LINEAR in scales, so normalizing the
  compressed ket is a pure scale update (engines/turboquant.py).
"""

from __future__ import annotations

import numpy as np

DEFAULT_BLOCK_POW = 6   # D = 64 complex amps -> 128x128 rotation
DEFAULT_BITS = 8
DEFAULT_SEED = 0x7142_7142_7142_7142


def rotation_matrix(d: int, seed: int = DEFAULT_SEED) -> np.ndarray:
    """Deterministic random orthogonal (d, d) float32 matrix from a seed
    (Gaussian fill + QR with a sign-fixed diagonal)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    q, r = np.linalg.qr(rng.standard_normal((d, d)))
    q *= np.sign(np.diagonal(r))
    return np.ascontiguousarray(q, dtype=np.float32)


def code_dtype(bits: int):
    return np.int8 if bits <= 8 else np.int16


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def planes_to_rows(planes: np.ndarray, block: int) -> np.ndarray:
    """(2, N) planes -> (B, 2D) block rows (concatenated re/im)."""
    b = planes.shape[-1] // block
    return (planes.reshape(2, b, block).transpose(1, 0, 2)
            .reshape(b, 2 * block))


def rows_to_planes(rows: np.ndarray, block: int) -> np.ndarray:
    """(B, 2D) block rows -> (2, N) planes."""
    b = rows.shape[0]
    return (rows.reshape(b, 2, block).transpose(1, 0, 2)
            .reshape(2, b * block))


def quantize_blocks(state: np.ndarray, bits: int = DEFAULT_BITS,
                    block_pow: int = 12, seed: int = DEFAULT_SEED):
    """Complex vector -> (scales, codes, n) per rotated block."""
    state = np.asarray(state).reshape(-1)
    n = state.shape[0]
    block = min(1 << block_pow, n)
    pad = (-n) % block
    if pad:
        state = np.concatenate([state, np.zeros(pad, dtype=state.dtype)])
    planes = np.stack([state.real, state.imag]).astype(np.float32)
    rows = planes_to_rows(planes, block)
    rot = rows @ rotation_matrix(2 * block, seed)
    scales = np.max(np.abs(rot), axis=1)
    safe = np.where(scales > 0, scales, 1.0)
    q = qmax(bits)
    codes = np.round(rot / safe[:, None] * q).astype(code_dtype(bits))
    return scales.astype(np.float32), codes, n


def dequantize_blocks(scales: np.ndarray, codes: np.ndarray, n: int,
                      bits: int = DEFAULT_BITS, seed: int = DEFAULT_SEED,
                      normalize: bool = True) -> np.ndarray:
    block = codes.shape[1] // 2
    rot = codes.astype(np.float32) * (scales / qmax(bits))[:, None]
    rows = rot @ rotation_matrix(2 * block, seed).T
    flat = rows_to_planes(rows, block)
    out = (flat[0] + 1j * flat[1]).astype(np.complex128)[:n]
    if normalize:
        # renormalize: quantization perturbs the norm slightly
        nrm = np.linalg.norm(out)
        if nrm > 0:
            out = out / nrm
    return out


def dequantize_blocks_v1(scales: np.ndarray, codes: np.ndarray, n: int,
                         bits: int = DEFAULT_BITS,
                         normalize: bool = True) -> np.ndarray:
    """Decode the older pre-rotation block format: per-plane max-abs int
    codes with (2, B) scales and no decorrelating rotation, so archives
    in that format still load."""
    q = qmax(bits)
    planes = codes.astype(np.float32) * (scales[..., None] / q)
    flat = planes.reshape(2, -1)
    out = (flat[0] + 1j * flat[1]).astype(np.complex128)[:n]
    if normalize:
        nrm = np.linalg.norm(out)
        if nrm > 0:
            out = out / nrm
    return out


LOSSY_KIND = "turboquant-lossy-ket"


def _npz_path(path) -> str:
    # np.savez_compressed appends .npz to bare paths; keep that naming
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def lossy_save(state: np.ndarray, path: str, bits: int = DEFAULT_BITS,
               block_pow: int = 12, seed: int = DEFAULT_SEED) -> None:
    from ..checkpoint.container import save_container

    scales, codes, n = quantize_blocks(state, bits=bits,
                                       block_pow=block_pow, seed=seed)
    # the payload keeps the bare-npz member layout (scales/codes/n/bits/
    # seed), so readers without the manifest still load these files
    save_container(_npz_path(path),
                   {"scales": scales, "codes": codes,
                    "n": np.asarray(n), "bits": np.asarray(bits),
                    "seed": np.asarray(seed)},
                   meta={"n": int(n), "bits": int(bits), "seed": int(seed)},
                   kind=LOSSY_KIND)


def lossy_load(path: str) -> np.ndarray:
    from ..checkpoint.container import load_container

    # container files verify checksums here; a bare npz (kind None)
    # loads unverified — both carry the same member layout
    _, _, z = load_container(_npz_path(path), legacy_ok=True)

    def scalar(key):  # container members are at-least-1-d
        return int(np.ravel(z[key])[0])

    if "seed" in z:
        return dequantize_blocks(z["scales"], z["codes"], scalar("n"),
                                 scalar("bits"), seed=scalar("seed"))
    # pre-rotation format: per-plane max-abs int codes with (2, B)
    # scales, no decorrelating rotation
    return dequantize_blocks_v1(z["scales"], z["codes"], scalar("n"),
                                scalar("bits"))
