"""Viewer / FrameDrawer / MapDrawer (src/Viewer.cc, FrameDrawer.cc,
MapDrawer.cc).

The reference renders with Pangolin/OpenGL in a dedicated thread; this
build renders headlessly (matplotlib Agg + raw NumPy overlays) — the right
trade for an accelerator host, which has no display. The Viewer thread polls the
Atlas at the configured FPS and writes PNG frames to a directory (playable
as a video; the reference's interactive pause/step UI maps to just reading
the files). All drawing is pure host-side NumPy/matplotlib: nothing touches
the device.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np


class FrameDrawer:
    """FrameDrawer.cc: the current frame with keypoint overlays — green
    squares for map-point matches, blue for unmatched detections, plus the
    state banner."""

    COL_TRACKED = np.array([0, 220, 0], np.uint8)
    COL_FREE = np.array([80, 80, 255], np.uint8)

    def draw(self, image: np.ndarray, frame, state=None) -> np.ndarray:
        img = np.asarray(image)
        if img.ndim == 2:
            rgb = np.repeat(img[..., None], 3, axis=-1).astype(np.uint8)
        else:
            rgb = img.astype(np.uint8).copy()
        h, w = rgb.shape[:2]
        if frame is not None:
            uv = frame.kp_uv.astype(int)
            tracked = frame.mp_ids >= 0
            for sel, col in ((~tracked & frame.valid, self.COL_FREE),
                             (tracked, self.COL_TRACKED)):
                for x, y in uv[sel]:
                    x0, x1 = max(x - 2, 0), min(x + 3, w)
                    y0, y1 = max(y - 2, 0), min(y + 3, h)
                    rgb[y0:y1, x0] = col
                    rgb[y0:y1, x1 - 1] = col
                    rgb[y0, x0:x1] = col
                    rgb[y1 - 1, x0:x1] = col
        if state is not None:
            # state banner: a colored strip (green OK / orange lost / gray)
            name = getattr(state, "name", str(state))
            col = {"OK": (0, 180, 0), "RECENTLY_LOST": (230, 140, 0)}.get(
                name, (120, 120, 120)
            )
            rgb[:6, :] = col
        return rgb


class MapDrawer:
    """MapDrawer.cc: 3D view of map points, keyframe frusta (as positions),
    and the trajectory, rendered via matplotlib Agg to an RGB array."""

    def draw(self, atlas, trajectory=None, figsize=(6, 6)) -> np.ndarray:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(111, projection="3d")
        m = atlas.current
        st = m.store
        alive = st.alive[: st.n_rows]
        if alive.any():
            P = st.pos[: st.n_rows][alive]
            ax.scatter(P[:, 0], P[:, 1], P[:, 2], s=1, c="k", alpha=0.3)
        if m.keyframes:
            C = np.stack([kf.center for kf in m.keyframes.values()])
            ax.scatter(C[:, 0], C[:, 1], C[:, 2], s=16, c="tab:blue")
        if trajectory:
            T = np.stack([-R.T @ t for _, R, t in trajectory])
            ax.plot(T[:, 0], T[:, 1], T[:, 2], c="tab:green", lw=1)
        ax.set_title(f"map {m.map_id}: {m.n_keyframes()} KFs, "
                     f"{m.n_mappoints()} points")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
        plt.close(fig)
        return buf


class Viewer:
    """Viewer.cc: a background thread rendering frame + map views at the
    configured FPS into ``out_dir`` (frame_%06d.png / map_%06d.png)."""

    def __init__(self, system, out_dir: str, fps: float = 2.0):
        self.system = system
        self.out_dir = out_dir
        self.period = 1.0 / max(fps, 0.1)
        self.frame_drawer = FrameDrawer()
        self.map_drawer = MapDrawer()
        self.last_image = None      # set via push_image from the caller
        self._stop = False
        self._n = 0
        self._thread = None
        os.makedirs(out_dir, exist_ok=True)

    def push_image(self, image: np.ndarray):
        self.last_image = np.asarray(image)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=5)

    def render_once(self) -> tuple:
        """One frame+map render (also the unit the thread loops on)."""
        from PIL import Image

        tr = self.system.tracker
        fr = tr.last_frame
        paths = []
        if self.last_image is not None and fr is not None:
            img = self.frame_drawer.draw(self.last_image, fr, tr.state)
            p = os.path.join(self.out_dir, f"frame_{self._n:06d}.png")
            Image.fromarray(img).save(p)
            paths.append(p)
        with self.system.atlas.current.lock:
            mp = self.map_drawer.draw(self.system.atlas, tr.trajectory)
        p = os.path.join(self.out_dir, f"map_{self._n:06d}.png")
        Image.fromarray(mp).save(p)
        paths.append(p)
        self._n += 1
        return tuple(paths)

    def _run(self):
        while not self._stop:
            try:
                self.render_once()
            except Exception:  # rendering must never kill tracking
                pass
            time.sleep(self.period)
