"""Frame sources: the capture layer feeding the pipeline (a copy of
``dynamicfusion_tpu.io.capture``). A uniform ``FrameSource`` interface
yields (depth uint16 mm, optional color) pairs, with three
implementations:

- ``DatasetSource``: VolumeDeform-layout depth/color PNG directories,
  decoded through the native prefetching loader;
- ``SyntheticSource``: procedural deforming scenes (test and bench input);
- ``OpenNISource``: live Kinect or recorded .oni, the reference's class
  surface (grab, set_registration, the shadow/no-sample constants); it
  needs the OpenNI python bindings, and constructing it without them
  raises with guidance.

Frames are numpy on the host; ``DynamicFusion`` copies them to its device.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from dynamicfusion_tpu_torch.config import Intrinsics

Frame = Tuple[np.ndarray, Optional[np.ndarray]]  # (depth uint16 mm, color)


class FrameSource:
    """Minimal interface: ``grab()`` returns the next (depth, color) or
    None at end of stream; sources are also iterable."""

    def grab(self) -> Optional[Frame]:
        raise NotImplementedError

    def intrinsics(self) -> Optional[Intrinsics]:
        """Camera intrinsics when the source knows them, else None (the
        caller falls back to the config's)."""
        return None

    def close(self) -> None:
        pass

    def __iter__(self) -> Iterator[Frame]:
        while True:
            f = self.grab()
            if f is None:
                return
            yield f

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DatasetSource(FrameSource):
    """Depth(+color) PNG sequence under ``root/depth`` and ``root/color``."""

    def __init__(self, root: str, with_color: bool = True, threads: int = 4):
        from dynamicfusion_tpu_torch.io.dataset import DepthSequence

        self._seq = DepthSequence(root, threads=threads)
        self._with_color = with_color
        self._i = 0

    def __len__(self) -> int:
        return len(self._seq)

    def grab(self) -> Optional[Frame]:
        if self._i >= len(self._seq):
            return None
        d = self._seq.depth(self._i)
        c = self._seq.color(self._i) if self._with_color else None
        self._i += 1
        return d, c

    def close(self) -> None:
        self._seq.close()


class SyntheticSource(FrameSource):
    """Procedural deforming scene: one large + one oscillating sphere over
    a plane (the bench workload; same dense-depth smooth-motion shape as
    the umbrella sequence)."""

    def __init__(self, cfg, n_frames: int, amplitude: float = 0.008):
        self._cfg = cfg
        self._n = n_frames
        self._amp = amplitude
        self._i = 0

    def __len__(self) -> int:
        return self._n

    def grab(self) -> Optional[Frame]:
        if self._i >= self._n:
            return None
        from dynamicfusion_tpu_torch.io import synthetic

        cfg, t = self._cfg, self._i
        sp = [
            dict(center=(0.0, 0.0, 0.95), radius=0.22),
            dict(center=(0.2 + self._amp * np.sin(0.4 * t), 0.1, 0.8), radius=0.1),
        ]
        self._i += 1
        d = synthetic.scene_depth(cfg.intr, cfg.rows, cfg.cols, spheres=sp, plane_z=1.25)
        return np.asarray(d, np.uint16), None

    def intrinsics(self) -> Optional[Intrinsics]:
        return self._cfg.intr


class OpenNISource(FrameSource):
    """Live Kinect / .oni playback (the reference's OpenNISource).

    Requires the ``openni`` python bindings and a sensor or recording;
    without them construction fails with guidance rather than at import
    time. The class still defines the reference's constants so downstream
    code can be written against it."""

    # the reference's registration defaults
    shadow_value = 0
    no_sample_value = 0

    def __init__(self, device: int | str = 0):
        try:
            from openni import openni2  # type: ignore
        except ImportError as e:
            raise ImportError(
                "OpenNISource needs the 'openni' python bindings and a "
                "connected sensor or .oni recording; this environment has "
                "neither. Use DatasetSource (PNG sequences) or "
                "SyntheticSource instead."
            ) from e
        openni2.initialize()
        if isinstance(device, str):
            self._dev = openni2.Device.open_file(device.encode())
        else:
            self._dev = openni2.Device.open_any()
        self._depth = self._dev.create_depth_stream()
        self._color = self._dev.create_color_stream()
        self._depth.start()
        self._color.start()
        self._registration = False

    def set_registration(self, value: bool = False) -> None:
        """Depth-to-color registration (OpenNISource::setRegistration)."""
        from openni import openni2  # type: ignore

        mode = (
            openni2.IMAGE_REGISTRATION_DEPTH_TO_COLOR
            if value
            else openni2.IMAGE_REGISTRATION_OFF
        )
        self._dev.set_image_registration_mode(mode)
        self._registration = value

    def grab(self) -> Optional[Frame]:
        df = self._depth.read_frame()
        cf = self._color.read_frame()
        d = np.frombuffer(df.get_buffer_as_uint16(), np.uint16).reshape(
            df.height, df.width
        )
        c = np.frombuffer(cf.get_buffer_as_uint8(), np.uint8).reshape(
            cf.height, cf.width, 3
        )
        return d.copy(), c.copy()

    def intrinsics(self) -> Optional[Intrinsics]:
        # VGA depth focal length from the stream FoV (the reference derives
        # it from ZPPS * pixel size)
        import math

        fov = self._depth.get_horizontal_fov()
        mode = self._depth.get_video_mode()
        fx = mode.resolutionX / (2.0 * math.tan(fov / 2.0))
        return Intrinsics(
            fx=fx, fy=fx, cx=mode.resolutionX / 2.0, cy=mode.resolutionY / 2.0
        )

    def close(self) -> None:
        self._depth.stop()
        self._color.stop()


def open_source(spec: str, cfg=None, n_frames: int = 100) -> FrameSource:
    """Open a frame source from a CLI-style spec: a dataset directory,
    'synthetic[:N]', an .oni file, or 'openni[:device]'."""
    if spec.startswith("synthetic"):
        if cfg is None:
            raise ValueError("synthetic source needs a config")
        parts = spec.split(":")
        return SyntheticSource(cfg, int(parts[1]) if len(parts) > 1 else n_frames)
    if spec.endswith(".oni") or spec.startswith("openni"):
        dev: int | str = spec
        if spec.startswith("openni"):
            parts = spec.split(":")
            dev = int(parts[1]) if len(parts) > 1 else 0
        return OpenNISource(dev)
    return DatasetSource(spec)
