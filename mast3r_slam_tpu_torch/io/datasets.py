"""Dataset adapters (TUM, EuRoC, ETH3D, 7-Scenes, MP4, RGB dirs, webcam,
RealSense).

The port's copy of ``mast3r_slam_tpu/io/datasets.py``: the per-dataset
timestamp and calibration conventions, the undistortion remaps and the
intrinsics rescaled to the resized, cropped frame (``K_frame``). Decoding
runs on the host. ``cv2``, ``yaml`` and ``pyrealsense2`` are imported where
they are used; a missing module raises its ``ImportError`` there.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np

from .image import resize_img


class MonocularDataset:
    def __init__(self):
        self.rgb_files = []
        self.timestamps = []
        self.img_size = 512
        self.camera_intrinsics = None
        self.use_calibration = False
        self.save_results = True
        self.dataset_path = None

    def __len__(self):
        return len(self.rgb_files)

    def __getitem__(self, idx):
        img = self.get_image(idx)
        return self.get_timestamp(idx), img

    def get_timestamp(self, idx):
        return self.timestamps[idx]

    def read_img(self, idx):
        import cv2

        img = cv2.imread(str(self.rgb_files[idx]))
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def get_image(self, idx):
        img = self.read_img(idx)
        if self.use_calibration and self.camera_intrinsics is not None:
            img = self.camera_intrinsics.remap(img)
        return img.astype(np.float32) / 255.0

    def get_img_shape(self):
        img = self.read_img(0)
        res = resize_img(img, self.img_size)
        return res["true_shape"], img.shape[:2]

    def subsample(self, stride: int):
        self.rgb_files = self.rgb_files[::stride]
        self.timestamps = self.timestamps[::stride]

    def has_calib(self):
        return self.camera_intrinsics is not None


def _tum_style_list(dataset_path):
    """(files, timestamps) of a ``rgb.txt`` of ``timestamp path`` lines."""
    tstamp_rgb = np.loadtxt(dataset_path / "rgb.txt", delimiter=" ",
                            dtype=np.str_, skiprows=0)
    return ([dataset_path / f for f in tstamp_rgb[:, 1]],
            list(tstamp_rgb[:, 0]))


class TUMDataset(MonocularDataset):
    """TUM RGB-D with the fr1/fr2/fr3 factory calibrations."""

    CALIBS = {
        1: [517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054, 0.0026,
            1.1633],
        2: [520.9, 521.0, 325.1, 249.7, 0.2312, -0.7849, -0.0033, -0.0001,
            0.9172],
        3: [535.4, 539.2, 320.1, 247.6],
    }

    def __init__(self, dataset_path, use_calib=False,
                 center_principle_point=True):
        super().__init__()
        self.use_calibration = use_calib
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files, self.timestamps = _tum_style_list(self.dataset_path)
        m = re.search(r"freiburg(\d+)", str(dataset_path))
        if m:
            calib = np.array(self.CALIBS[int(m.group(1))])
            self.camera_intrinsics = Intrinsics.from_calib(
                self.img_size, 640, 480, calib, use_calib=use_calib,
                center_principle_point=center_principle_point)


class EurocDataset(MonocularDataset):
    """EuRoC MAV cam0; always undistorts."""

    def __init__(self, dataset_path, use_calib=False,
                 center_principle_point=True):
        super().__init__()
        import yaml

        self.use_calibration = True
        self.dataset_path = pathlib.Path(dataset_path)
        csv = np.loadtxt(self.dataset_path / "mav0/cam0/data.csv",
                         delimiter=",", dtype=np.str_, skiprows=0)
        self.rgb_files = [self.dataset_path / "mav0/cam0/data" / f
                          for f in csv[:, 1]]
        self.timestamps = list(csv[:, 0])
        with open(self.dataset_path / "mav0/cam0/sensor.yaml") as f:
            cam0 = yaml.safe_load(f)
        W, H = cam0["resolution"]
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, W, H,
            [*cam0["intrinsics"], *cam0["distortion_coefficients"]],
            use_calib=use_calib, always_undistort=True,
            center_principle_point=center_principle_point)

    def read_img(self, idx):
        import cv2

        img = cv2.imread(str(self.rgb_files[idx]), cv2.IMREAD_GRAYSCALE)
        return cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)


class ETH3DDataset(MonocularDataset):
    def __init__(self, dataset_path, use_calib=False,
                 center_principle_point=False):
        super().__init__()
        self.use_calibration = use_calib
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files, self.timestamps = _tum_style_list(self.dataset_path)
        calibration = np.loadtxt(self.dataset_path / "calibration.txt",
                                 delimiter=" ", dtype=np.float32)
        H, W = self.read_img(0).shape[:2]
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, W, H, calibration, use_calib=use_calib,
            center_principle_point=center_principle_point)


class SevenScenesDataset(MonocularDataset):
    def __init__(self, dataset_path, use_calib=False,
                 center_principle_point=True):
        super().__init__()
        self.use_calibration = use_calib
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files = sorted(
            (self.dataset_path / "seq-01").glob("*.color.png"),
            key=lambda p: _natkey(p.name))
        self.timestamps = [float(i) for i in range(len(self.rgb_files))]
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, 640, 480, [585.0, 585.0, 320.0, 240.0],
            use_calib=use_calib, center_principle_point=center_principle_point)


class MP4Dataset(MonocularDataset):
    def __init__(self, dataset_path, subsample=1, **_):
        super().__init__()
        import cv2

        self.dataset_path = pathlib.Path(dataset_path)
        self.cap = cv2.VideoCapture(str(self.dataset_path))
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.total_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.stride = subsample
        self.timestamps = [i * self.stride / self.fps
                           for i in range(len(self))]
        self._next_frame = 0

    def __len__(self):
        return self.total_frames // self.stride

    def subsample(self, stride):
        # the stride is applied when reading; keep the timestamps in step
        self.stride *= stride
        self.timestamps = [i * self.stride / self.fps
                           for i in range(len(self))]

    def read_img(self, idx):
        import cv2

        target = idx * self.stride
        if target != self._next_frame:
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, target)
        ok, img = self.cap.read()
        self._next_frame = target + 1
        if not ok:
            raise ValueError(f"failed to read frame {target}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class RGBFiles(MonocularDataset):
    """A directory of ``*.png`` (else ``*.jpg``) frames in natural order,
    at 30 frames/s."""

    def __init__(self, dataset_path, **_):
        super().__init__()
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files = sorted(self.dataset_path.glob("*.png"),
                                key=lambda p: _natkey(p.name))
        if not self.rgb_files:
            self.rgb_files = sorted(self.dataset_path.glob("*.jpg"),
                                    key=lambda p: _natkey(p.name))
        self.timestamps = [i / 30.0 for i in range(len(self.rgb_files))]


class Webcam(MonocularDataset):
    def __init__(self, **_):
        super().__init__()
        import cv2

        self.cap = cv2.VideoCapture(-1)
        self.save_results = False
        self._i = 0

    def __len__(self):
        return 999999

    def read_img(self, idx):
        import cv2

        ok, img = self.cap.read()
        if not ok:
            raise ValueError("failed to read webcam frame")
        self.timestamps.append(self._i / 30.0)
        self._i += 1
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class RealsenseDataset(MonocularDataset):
    """Live Intel RealSense colour stream: 640x480 RGB at 30 Hz,
    auto-exposure off, the factory intrinsics with ``use_calib``."""

    def __init__(self, use_calib=False, img_size=512, **_):
        super().__init__()
        import pyrealsense2 as rs

        self.rs = rs
        self.pipeline = rs.pipeline()
        cfg = rs.config()
        cfg.enable_stream(rs.stream.color, 640, 480, rs.format.rgb8, 30)
        profile = self.pipeline.start(cfg)
        sensor = profile.get_device().query_sensors()[1]
        sensor.set_option(rs.option.enable_auto_exposure, False)
        sensor.set_option(rs.option.exposure, 78.0)
        intr = (profile.get_stream(rs.stream.color)
                .as_video_stream_profile().get_intrinsics())
        self.save_results = False
        self._i = 0
        if use_calib:
            calib = [intr.fx, intr.fy, intr.ppx, intr.ppy]
            self.camera_intrinsics = Intrinsics.from_calib(
                img_size, intr.width, intr.height, calib, use_calib=True)
            self.use_calibration = True

    def __len__(self):
        return 999999

    def read_img(self, idx):
        frames = self.pipeline.wait_for_frames()
        img = np.asanyarray(frames.get_color_frame().get_data())
        self.timestamps.append(self._i / 30.0)
        self._i += 1
        if self.camera_intrinsics is not None:
            img = self.camera_intrinsics.remap(img)
        return img


def _natkey(s):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


class Intrinsics:
    """Camera intrinsics with the undistortion maps and ``K_frame``, the
    intrinsics of the resized, cropped frame."""

    def __init__(self, img_size, W, H, K_orig, K, distortion, mapx, mapy):
        self.img_size = img_size
        self.W, self.H = W, H
        self.K_orig = K_orig
        self.K = K
        self.distortion = distortion
        self.mapx, self.mapy = mapx, mapy
        _, (scale_w, scale_h, half_crop_w, half_crop_h) = resize_img(
            np.zeros((H, W, 3), dtype=np.uint8), img_size,
            return_transformation=True)
        self.K_frame = self.K.copy()
        self.K_frame[0, 0] = self.K[0, 0] / scale_w
        self.K_frame[1, 1] = self.K[1, 1] / scale_h
        self.K_frame[0, 2] = self.K[0, 2] / scale_w - half_crop_w
        self.K_frame[1, 2] = self.K[1, 2] / scale_h - half_crop_h

    def remap(self, img):
        if self.mapx is None:
            return img
        import cv2

        return cv2.remap(img, self.mapx, self.mapy, cv2.INTER_LINEAR)

    @staticmethod
    def from_calib(img_size, W, H, calib, use_calib=True,
                   always_undistort=False, center_principle_point=True):
        if not use_calib and not always_undistort:
            return None
        import cv2

        fx, fy, cx, cy = calib[:4]
        distortion = np.zeros(4)
        if len(calib) > 4:
            distortion = np.array(calib[4:])
        K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
        K_opt, _ = cv2.getOptimalNewCameraMatrix(
            K, distortion, (W, H), 0, (W, H),
            centerPrincipalPoint=center_principle_point)
        mapx, mapy = cv2.initUndistortRectifyMap(
            K, distortion, None, K_opt, (W, H), cv2.CV_32FC1)
        return Intrinsics(img_size, W, H, K, K_opt, distortion, mapx, mapy)


def load_dataset(dataset_path: str, use_calib=False,
                 center_principle_point=True, subsample=1):
    """The adapter for ``dataset_path``, chosen by a path component
    (``tum``, ``euroc``, ``eth3d``, ``7-scenes``, ``webcam``,
    ``realsense``), then a video extension, else a directory of frames."""
    parts = str(dataset_path).split("/")
    kw = dict(use_calib=use_calib,
              center_principle_point=center_principle_point)
    if "tum" in parts:
        return TUMDataset(dataset_path, **kw)
    if "euroc" in parts:
        return EurocDataset(dataset_path, **kw)
    if "eth3d" in parts:
        return ETH3DDataset(dataset_path, **kw)
    if "7-scenes" in parts:
        return SevenScenesDataset(dataset_path, **kw)
    if "webcam" in parts:
        return Webcam()
    if "realsense" in parts:
        return RealsenseDataset(use_calib=use_calib)
    ext = parts[-1].split(".")[-1].lower()
    if ext in ("mp4", "avi", "mov"):
        return MP4Dataset(dataset_path, subsample=subsample)
    return RGBFiles(dataset_path)
