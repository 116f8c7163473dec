"""Vote-grid peak utilities (counterpart of cppf_tpu/ops/peaks.py), plain
torch on the grid's device.

- :func:`peak_contrast` is a repaired re-design of the reference's dead
  ``findpeak`` kernel (reference models/voting.py:150-172: never called
  and broken upstream): the 6-neighbour contrast of each voxel.
- :func:`gaussian_blur3d` and :func:`extract_peaks` are the zero-shot
  notebook's multi-peak proposal extraction with suppression (reference
  nocs/zero_shot.ipynb cell 9): take the global argmax of the smoothed
  grid, keep it if it clears the mean of the shell around its suppression
  ball, zero the ball, repeat.

No path of the port runs them: the zero-shot path extracts its proposals on
the host (``eval/zero_shot.py::extract_proposals_host``), as the JAX
package's does.
"""
from __future__ import annotations

import torch


def _shift(grid: torch.Tensor, delta: int, axis: int) -> torch.Tensor:
    """Shift by ``delta`` along ``axis`` with index clamping at the borders."""
    n = grid.shape[axis]
    idx = torch.clamp(torch.arange(n, device=grid.device) - delta, 0, n - 1)
    return torch.index_select(grid, axis, idx)


def peak_contrast(grid: torch.Tensor, width: int = 1) -> torch.Tensor:
    """6-neighbour contrast: Σ_axis (2·g − g[+w] − g[−w]) with clamped borders."""
    out = torch.zeros_like(grid)
    for axis in range(3):
        out = out + (grid - _shift(grid, -width, axis)) + (grid - _shift(grid, width, axis))
    return out


def gaussian_blur3d(grid: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable 3D Gaussian smoothing, three 1D convolutions with zero
    padding (the kernel normalised to sum 1, truncated at ``radius``,
    default ⌊3σ + ½⌋)."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=grid.dtype, device=grid.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = (k / torch.sum(k)).reshape(1, 1, -1)
    out = grid
    for axis in range(3):
        moved = torch.movedim(out, axis, -1)
        shape = moved.shape
        conv = torch.nn.functional.conv1d(moved.reshape(-1, 1, shape[-1]), k, padding=radius)
        out = torch.movedim(conv.reshape(shape), -1, axis)
    return out


def extract_peaks(grid: torch.Tensor, max_peaks: int = 8, suppress_radius: int = 5,
                  min_contrast: float = 0.0):
    """Iterative argmax and ball suppression.

    Returns (coords [max_peaks, 3] int32, scores [max_peaks], valid mask
    [max_peaks]).  A peak is valid if its score (before suppression)
    exceeds ``1 + min_contrast`` times the mean of the one-voxel shell
    outside its suppression ball; ties in the argmax go to the first voxel
    in row-major order."""
    gx, gy, gz = grid.shape
    dev = grid.device
    xs = torch.arange(gx, device=dev)[:, None, None]
    ys = torch.arange(gy, device=dev)[None, :, None]
    zs = torch.arange(gz, device=dev)[None, None, :]
    g = grid
    coords, scores, oks = [], [], []
    for _ in range(max_peaks):
        flat = torch.argmax(g.reshape(-1))
        ix, iy, iz = flat // (gy * gz), (flat % (gy * gz)) // gz, flat % gz
        score = g.reshape(-1)[flat]
        dist2 = (xs - ix) ** 2 + (ys - iy) ** 2 + (zs - iz) ** 2
        ball = dist2 <= suppress_radius ** 2
        shell = (dist2 > suppress_radius ** 2) & (dist2 <= (suppress_radius + 1) ** 2)
        boundary = (torch.sum(torch.where(shell, g, 0.0))
                    / torch.clamp(torch.sum(shell), min=1).to(g.dtype))
        oks.append(score > boundary * (1.0 + min_contrast))
        g = torch.where(ball, 0.0, g)
        coords.append(torch.stack([ix, iy, iz]).to(torch.int32))
        scores.append(score)
    return torch.stack(coords), torch.stack(scores), torch.stack(oks)
