"""GIF renderings of attribution and localisation maps (matplotlib, host side).

Counterpart of ct_clip_ut_tpu/utils/visualizations.py: the same figure
layouts, colour maps, titles and file names, so a GIF of either package
decodes to the same frames. The three renderers (`visualize_overlay`,
`visualize_attention_grid_gif`, `visualize_pathology_heatmaps`) are panel
lists fed to one animator, `_animate`, which saves a pillow GIF with one
frame per depth slice. `results_subdirectory` claims an indexed run
directory atomically.

matplotlib (and pillow, its GIF writer) is imported only when a GIF is
rendered; a render asked for where either does not import raises
ImportError naming the package, never a quiet skip. `require_renderer`
makes that check up front (the CLIs call it before loading a model).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..config import PATHOLOGIES

COLORS = ["red", "green", "blue", "cyan", "magenta", "yellow", "orange", "purple", "pink",
          "lime", "teal", "brown", "olive", "navy", "gold", "salmon", "turquoise", "indigo"]


def require_renderer() -> None:
    """Raise ImportError naming matplotlib or pillow where either does not
    import: the GIF renderers need both."""
    for module, package in (("matplotlib", "matplotlib"), ("PIL", "pillow")):
        try:
            __import__(module)
        except ImportError as e:
            raise ImportError(f"rendering GIFs needs {package}, which does not import here "
                              f"({e})") from e


def _mpl():
    require_renderer()
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt
    return plt, animation


def normalize(volume: np.ndarray) -> np.ndarray:
    """volume - min, divided by its max where that is positive."""
    volume = volume - volume.min()
    if volume.max() > 0:
        volume = volume / volume.max()
    return volume


def results_subdirectory(results_folder, visualization_name: str) -> Path:
    """results_folder/visualization_name/<k>, k one more than the run
    directories already there; the claim is a mkdir that fails if the
    directory exists, retried upward, so concurrent claimants get distinct
    directories."""
    subdir = Path(results_folder) / visualization_name
    subdir.mkdir(parents=True, exist_ok=True)
    idx = len([d for d in subdir.iterdir() if d.is_dir()]) + 1
    while True:
        out = subdir / str(idx)
        try:
            out.mkdir(parents=False, exist_ok=False)
            return out
        except FileExistsError:
            idx += 1


class _Layer(NamedTuple):
    """One imshow a frame: volume[d] with these arguments; alpha_from_data
    takes the slice itself as its alpha (heat shows only where it is)."""
    volume: np.ndarray                       # [D, H, W]
    cmap: object
    vlim: Optional[Tuple[float, float]] = None
    alpha_from_data: bool = False


class _Panel(NamedTuple):
    """One axes cell: its stacked layers and decorations."""
    rc: Tuple[int, int]
    layers: Tuple[_Layer, ...]
    title: str = ""
    title_fontsize: int = 12
    ylabel: str = ""


def _animate(panels: Sequence[_Panel], grid: Tuple[int, int], depth: int, save_path, *,
             figsize, suptitle: str = "", extra_text: str = "",
             colorbar_on: Optional[_Panel] = None, colorbar_label: str = "",
             colorbar_rect=(0.35, 0.08, 0.3, 0.02), interval: int = 100, fps: int = 10) -> None:
    """Build the axes grid, one list of image artists a depth slice, and
    save the animation as a pillow GIF; titles, axes and the colour bar are
    drawn once."""
    plt, animation = _mpl()
    fig, axes = plt.subplots(*grid, figsize=figsize)
    axes = np.asarray(axes).reshape(grid)
    if suptitle:
        fig.suptitle(suptitle, fontsize=16)
    if extra_text:
        fig.text(0.00, 0.99, str(extra_text), fontsize=10, ha="left", va="top")
    for p in panels:
        ax = axes[p.rc]
        if p.title:
            ax.set_title(p.title, fontsize=p.title_fontsize)
        if p.ylabel:
            ax.set_ylabel(p.ylabel, fontsize=p.title_fontsize)
    for ax in axes.ravel():
        ax.axis("off")

    frames, cbar_artist = [], None
    for d in range(depth):
        artists = []
        for p in panels:
            ax = axes[p.rc]
            for layer in p.layers:
                kw = dict(cmap=layer.cmap, animated=True)
                if layer.vlim is not None:
                    kw["vmin"], kw["vmax"] = layer.vlim
                sl = layer.volume[d]
                if layer.alpha_from_data:
                    kw["alpha"] = sl
                artists.append(ax.imshow(sl, **kw))
                if d == 0 and colorbar_on is p and cbar_artist is None:
                    cbar_artist = artists[-1]
        frames.append(artists)
    if cbar_artist is not None:
        cbar = fig.colorbar(cbar_artist, cax=fig.add_axes(colorbar_rect),
                            orientation="horizontal")
        if colorbar_label:
            cbar.set_label(colorbar_label, fontsize=12)
    ani = animation.ArtistAnimation(fig, frames, interval=interval, blit=False,
                                    repeat_delay=1000)
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    ani.save(str(save_path), writer="pillow", fps=fps)
    plt.close(fig)


def _scan_heat_overlay(row: int, image, heat, cmap, titles, fontsize: int) -> list:
    """The [scan | heatmap | overlay] panels of one row."""
    return [_Panel((row, 0), (_Layer(image, "bone"),), titles[0], fontsize),
            _Panel((row, 1), (_Layer(heat, cmap, (0.0, 1.0)),), titles[1], fontsize),
            _Panel((row, 2), (_Layer(image, "bone"),
                              _Layer(heat, cmap, (0.0, 1.0), alpha_from_data=True)),
                   titles[2], fontsize)]


def visualize_overlay(image: np.ndarray, overlay: np.ndarray, scan_name: str,
                      overlay_name: str, save_path, threshold: float = 0.0,
                      extra_info: str = "", display_flags: Optional[dict] = None,
                      fps: int = 10) -> None:
    """Scan, heatmap and overlay panels ([D, H, W] each) animated over
    depth; `display_flags` picks which of the three appear."""
    if display_flags is None:
        display_flags = {"original": True, "heatmap": True, "overlay": True}
    overlay = np.where(overlay < threshold, 0.0, overlay)
    views = {
        "original": ((_Layer(image, "bone"),), "Original Scan"),
        "heatmap": ((_Layer(overlay, "inferno", (0.0, 1.0)),), f"{overlay_name} Heatmap"),
        "overlay": ((_Layer(image, "bone"),
                     _Layer(overlay, "inferno", (0.0, 1.0), alpha_from_data=True)),
                    "Scan + Heatmap"),
    }
    order = [v for v in views if display_flags.get(v)]
    panels = [_Panel((0, i), *views[v]) for i, v in enumerate(order)]
    heat_panel = panels[order.index("heatmap")] if "heatmap" in order else None
    _animate(panels, (1, len(order)), image.shape[0], save_path, figsize=(6 * len(order), 6),
             suptitle=f"Scan: {scan_name}", extra_text=extra_info, colorbar_on=heat_panel,
             colorbar_label=f"{overlay_name} Intensity", fps=fps)


def visualize_attention_grid_gif(volumes: np.ndarray, scan_name: str, save_path,
                                 fps: int = 6) -> None:
    """A heads x layers grid of [layers, heads, D, H, W] maps animated over
    depth."""
    num_layers, num_heads = volumes.shape[:2]
    panels = [_Panel((i, j), (_Layer(volumes[j, i], "inferno", (0.0, 1.0)),),
                     title=f"Layer {j}" if i == 0 else "", title_fontsize=10,
                     ylabel=f"Head {i}" if j == 0 else "")
              for i in range(num_heads) for j in range(num_layers)]
    _animate(panels, (num_heads, num_layers), volumes.shape[2], save_path,
             figsize=(4 * num_layers, 3 * num_heads), fps=fps)


def visualize_pathology_heatmaps(image: np.ndarray, heatmaps: Dict[str, np.ndarray], save_path,
                                 interval: int = 100, figsize=None,
                                 pathologies: Sequence[str] = PATHOLOGIES,
                                 fps: int = 10) -> None:
    """One [scan | heatmap | overlay] row a pathology, animated over depth,
    each pathology's heat in a map from transparent to its own colour."""
    _mpl()
    from matplotlib.colors import LinearSegmentedColormap, to_rgba
    if figsize is None:
        figsize = (12, 4 * len(heatmaps))
    cmaps = {p: LinearSegmentedColormap.from_list(f"{p.replace(' ', '_')}_cmap",
                                                  [to_rgba("black", 0.0), to_rgba(c, 1.0)])
             for p, c in zip(pathologies, COLORS)}
    panels = []
    for row, (pathology, heat) in enumerate(heatmaps.items()):
        panels += _scan_heat_overlay(row, image, heat, cmaps.get(pathology, "inferno"),
                                     (f"{pathology} - Scan", f"{pathology} - Heatmap",
                                      f"{pathology} - Overlay"), 8)
    _animate(panels, (len(heatmaps), 3), image.shape[0], save_path, figsize=figsize,
             interval=interval, fps=fps)
