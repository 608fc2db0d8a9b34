"""Live-viewer socket server, wire-compatible with the SIBR remote viewer
(`vidu4d_tpu/utils/network_gui.py`; the port's own copy, numpy + socket).

Re-implements the reference's training-time GUI bridge
(``gs/gaussian_renderer/network_gui.py:26-86`` and the interaction loop in
``gs/train.py:52-65``) as a self-contained, testable server class instead of
module globals. The wire protocol is unchanged so the stock SIBR
``remoteGaussian`` client can connect:

  client -> server : 4-byte little-endian length + JSON request
                     {resolution_x/y, train, fov_x/y, z_near/far,
                      shs_python, rot_scale_python, keep_alive,
                      scaling_modifier, view_matrix[16],
                      view_projection_matrix[16]}
  server -> client : H*W*3 raw uint8 RGB bytes (row-major) when a camera was
                     supplied, then 4-byte little-endian length + ASCII
                     "verify" string (the dataset source path).

Camera conversion: the client sends the 3DGS ``world_view_transform`` in
row-vector convention with OpenGL-style axes; the reference flips columns
1 and 2 (gs/gaussian_renderer/network_gui.py:75-76). Our rasterizer wants a
column-vector world->camera matrix, so we flip then transpose, and derive
pinhole intrinsics from the fovs instead of consuming the projection matrix.
"""

from __future__ import annotations

import json
import math
import socket
from typing import Callable, NamedTuple, Optional

import numpy as np


class ViewerCamera(NamedTuple):
    """A render request from the viewer, in this framework's conventions."""

    width: int
    height: int
    viewmat: np.ndarray   # (4,4) world->camera, column-vector convention
    intrins: np.ndarray   # (4,) fx, fy, cx, cy
    znear: float
    zfar: float
    scaling_modifier: float
    shs_python: bool
    rot_scale_python: bool


# RenderFn: ViewerCamera -> (H, W, 3) float array in [0, 1]
RenderFn = Callable[[ViewerCamera], np.ndarray]


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("viewer disconnected")
        buf += chunk
    return buf


def parse_request(message: dict) -> Optional[ViewerCamera]:
    """JSON request -> ViewerCamera (None for 0-resolution keepalives)."""
    width = int(message["resolution_x"])
    height = int(message["resolution_y"])
    if width == 0 or height == 0:
        return None
    w2c = np.asarray(message["view_matrix"], np.float32).reshape(4, 4)
    w2c = w2c.copy()
    w2c[:, 1] *= -1.0  # GL -> vision axes, as network_gui.py:75-76
    w2c[:, 2] *= -1.0
    viewmat = w2c.T    # row-vector -> column-vector convention
    fovx = float(message["fov_x"])
    fovy = float(message["fov_y"])
    fx = width / (2.0 * math.tan(max(fovx, 1e-6) / 2.0))
    fy = height / (2.0 * math.tan(max(fovy, 1e-6) / 2.0))
    intrins = np.array([fx, fy, width / 2.0, height / 2.0], np.float32)
    return ViewerCamera(
        width=width,
        height=height,
        viewmat=viewmat,
        intrins=intrins,
        znear=float(message["z_near"]),
        zfar=float(message["z_far"]),
        scaling_modifier=float(message.get("scaling_modifier", 1.0)),
        shs_python=bool(message.get("shs_python", False)),
        rot_scale_python=bool(message.get("rot_scale_python", False)),
    )


def encode_image(img) -> bytes:
    """(H, W, 3) float [0,1] -> raw uint8 RGB bytes, as gs/train.py:60."""
    arr = np.asarray(img)
    arr = np.clip(arr, 0.0, 1.0)
    return np.ascontiguousarray((arr * 255.0).astype(np.uint8)).tobytes()


class ViewerServer:
    """Non-blocking viewer bridge, polled once per training iteration."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6323,
                 source_path: str = ""):
        self.source_path = source_path
        self.conn: Optional[socket.socket] = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.port = self.listener.getsockname()[1]  # resolved if port=0

    # -- wire helpers -----------------------------------------------------
    def _read_request(self) -> dict:
        n = int.from_bytes(_recv_exact(self.conn, 4), "little")
        return json.loads(_recv_exact(self.conn, n).decode("utf-8"))

    def _send(self, image_bytes: Optional[bytes]) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        verify = self.source_path
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    # -- train-loop entry point -------------------------------------------
    def poll(self, render_fn: RenderFn, training_done: bool = False) -> int:
        """Serve pending viewer requests; returns #frames rendered.

        Mirrors gs/train.py:52-65: accept a client if none, then serve
        requests until the client asks training to resume (``train`` true
        and either training is unfinished or ``keep_alive`` is false).
        """
        if self.conn is None:
            try:
                self.conn, _ = self.listener.accept()
                self.conn.settimeout(None)
            except (BlockingIOError, socket.timeout, OSError):
                return 0
        served = 0
        while self.conn is not None:
            try:
                message = self._read_request()
                cam = parse_request(message)
                image_bytes = None
                if cam is not None:
                    image_bytes = encode_image(render_fn(cam))
                    served += 1
                self._send(image_bytes)
                do_training = bool(message.get("train", False))
                keep_alive = bool(message.get("keep_alive", False))
                if do_training and (not training_done or not keep_alive):
                    break
            except Exception:
                try:
                    self.conn.close()
                except OSError:
                    pass
                self.conn = None
        return served

    def close(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None
        self.listener.close()


def make_request(width: int, height: int, viewmat: np.ndarray,
                 fovx: float, fovy: float, *, train: bool = True,
                 keep_alive: bool = True, scaling_modifier: float = 1.0,
                 znear: float = 0.01, zfar: float = 100.0) -> bytes:
    """Client-side encoder (what SIBR sends); used by tests and scripting.

    ``viewmat`` is OUR convention (column-vector world->camera); this
    converts back to the wire's flipped row-vector layout.
    """
    w2c = np.asarray(viewmat, np.float32).T.copy()
    w2c[:, 1] *= -1.0
    w2c[:, 2] *= -1.0
    payload = json.dumps({
        "resolution_x": width, "resolution_y": height,
        "train": train, "fov_x": fovx, "fov_y": fovy,
        "z_near": znear, "z_far": zfar,
        "shs_python": False, "rot_scale_python": False,
        "keep_alive": keep_alive, "scaling_modifier": scaling_modifier,
        "view_matrix": [float(v) for v in w2c.reshape(-1)],
        "view_projection_matrix": [float(v) for v in np.eye(4).reshape(-1)],
    }).encode("utf-8")
    return len(payload).to_bytes(4, "little") + payload
