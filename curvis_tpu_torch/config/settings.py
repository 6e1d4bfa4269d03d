"""TOML-backed settings (the ``curvis_tpu.config.settings`` surface).

The same categories (image / video / camera / simulation / metric), knob
names, defaults and validation as ``curvis_tpu/config/settings.py``; only
``MetricSettings.make`` differs: it builds the port's metrics.  The default
TOMLs are the port's own copies, packaged beside this module in
``defaults/`` (byte for byte those of ``curvis_tpu/config/defaults/``).
"""
from __future__ import annotations

import dataclasses
import tomllib
from pathlib import Path


class SettingsError(ValueError):
    pass


def _load_toml(path) -> dict:
    p = Path(path)
    if p.suffix != ".toml":
        raise SettingsError(f"{p} is not a .toml file")
    if not p.exists():
        raise SettingsError(f"settings file {p} does not exist")
    with open(p, "rb") as f:
        return tomllib.load(f)


def defaults_dir() -> Path:
    """The directory of the default settings TOMLs."""
    return Path(__file__).resolve().parent / "defaults"


def _default_toml(name: str) -> dict:
    return tomllib.loads((defaults_dir() / name).read_text())


@dataclasses.dataclass(frozen=True)
class CameraSettings:
    resolution_x: int = 960
    resolution_y: int = 540
    diagonal: float = 43.0
    focal_length: float = 15.0

    def validate(self):
        if self.resolution_x <= 0 or self.resolution_y <= 0:
            raise SettingsError("resolution must be larger than zero")
        if self.diagonal <= 0:
            raise SettingsError("camera diagonal must be larger than zero")
        if self.focal_length <= 0:
            raise SettingsError("focal length must be larger than zero")
        return self

    @classmethod
    def from_toml(cls, path=None):
        d = _load_toml(path) if path else _default_toml("camera_settings.toml")
        return cls(**d).validate()


@dataclasses.dataclass(frozen=True)
class SimulationSettings:
    escape_radius: float = 100.0
    ray_integration_max_iterations: int = 40_000
    ray_integration_step: float = 0.05
    sampling_initial_nums: int = 100
    sampling_max_iterations: int = 50
    sampling_convergence_threshold_1: float = 1e-5
    sampling_convergence_threshold_2: float = 1e-5

    def validate(self):
        for name in ("escape_radius", "ray_integration_max_iterations",
                     "ray_integration_step", "sampling_initial_nums",
                     "sampling_max_iterations",
                     "sampling_convergence_threshold_1",
                     "sampling_convergence_threshold_2"):
            if getattr(self, name) <= 0:
                raise SettingsError(f"{name} must be larger than zero")
        return self

    @classmethod
    def from_toml(cls, path=None):
        d = _load_toml(path) if path else _default_toml(
            "simulation_settings.toml")
        # accept the reference's typo'd key
        if "ray_integration_max_itarations" in d:
            d["ray_integration_max_iterations"] = d.pop(
                "ray_integration_max_itarations")
        return cls(**d).validate()


@dataclasses.dataclass(frozen=True)
class ImageSettings:
    image_name: str = "output_image"
    t: float = 0.0
    l: float = 5.0
    theta: float = 1.5707963267948966
    phi: float = 0.0
    forward_x: float = -1.0
    forward_y: float = 0.0
    forward_z: float = 0.0
    up_x: float = 0.0
    up_y: float = 0.0
    up_z: float = 1.0

    def validate(self):
        if not self.image_name:
            raise SettingsError("image name cannot be an empty string")
        return self

    @property
    def position(self):
        return [self.t, self.l, self.theta, self.phi]

    @property
    def forward(self):
        return [self.forward_x, self.forward_y, self.forward_z]

    @property
    def up(self):
        return [self.up_x, self.up_y, self.up_z]

    @classmethod
    def from_toml(cls, path=None):
        d = _load_toml(path) if path else _default_toml("image_settings.toml")
        return cls(**d).validate()


@dataclasses.dataclass(frozen=True)
class VideoSettings:
    video_name: str = "output_video"
    frame_rate: float = 30.0
    filepath_to_camera_path: str = ""

    def validate(self):
        if not self.video_name:
            raise SettingsError("video name cannot be an empty string")
        if self.filepath_to_camera_path:
            p = Path(self.filepath_to_camera_path)
            if p.suffix != ".csv":
                raise SettingsError(f"camera path {p} is not a csv file")
            if not p.exists():
                raise SettingsError(f"camera path {p} does not exist")
        return self

    @classmethod
    def from_toml(cls, path=None):
        d = _load_toml(path) if path else _default_toml("video_settings.toml")
        s = cls(**d)
        if path and s.filepath_to_camera_path:
            # resolve relative to the settings file
            rel = Path(path).parent / s.filepath_to_camera_path
            if not Path(s.filepath_to_camera_path).is_absolute() and rel.exists():
                s = dataclasses.replace(s, filepath_to_camera_path=str(rel))
        return s.validate()


@dataclasses.dataclass(frozen=True)
class MetricSettings:
    kind: str = "ellis"
    rho: float = 1.0
    m: float = 0.1
    a: float = 1e-4
    q: float = 0.0

    def validate(self):
        if self.kind not in ("ellis", "interstellar", "schwarzschild",
                             "kerr", "reissner-nordstrom", "rn",
                             "kerr-newman", "kn"):
            raise SettingsError(f"unknown metric kind {self.kind!r}")
        if self.kind in ("ellis", "interstellar") and self.rho <= 0:
            raise SettingsError("rho must be positive")
        if self.kind == "interstellar" and (self.m <= 0 or self.a <= 0):
            raise SettingsError("m and a must be positive")
        if self.kind in ("schwarzschild", "kerr", "reissner-nordstrom",
                         "rn", "kerr-newman", "kn") and self.m <= 0:
            raise SettingsError("m must be positive")
        if self.kind == "kerr" and not (0 <= abs(self.a) < self.m):
            raise SettingsError("kerr requires |a| < m (sub-extremal)")
        if self.kind in ("reissner-nordstrom", "rn") \
                and abs(self.q) >= self.m:
            raise SettingsError("reissner-nordstrom requires |q| < m "
                                "(sub-extremal)")
        if self.kind in ("kerr-newman", "kn") \
                and self.a ** 2 + self.q ** 2 >= self.m ** 2:
            raise SettingsError("kerr-newman requires a^2 + q^2 < m^2 "
                                "(sub-extremal)")
        return self

    def make(self, *, device=None, dtype=None):
        """The port metric of these settings."""
        import torch
        from curvis_tpu_torch.metrics.base import make_metric
        kw = dict(device=device, dtype=dtype or torch.float32)
        if self.kind == "ellis":
            return make_metric("ellis", rho=self.rho, **kw)
        if self.kind == "schwarzschild":
            return make_metric("schwarzschild", m=self.m, **kw)
        if self.kind in ("reissner-nordstrom", "rn"):
            return make_metric("rn", m=self.m, q=self.q, **kw)
        if self.kind == "kerr":
            from curvis_tpu_torch.metrics.kerr import make_kerr
            return make_kerr(m=self.m, a=self.a, **kw)
        if self.kind in ("kerr-newman", "kn"):
            from curvis_tpu_torch.metrics.kerr import make_kerr_newman
            return make_kerr_newman(m=self.m, a=self.a, q=self.q, **kw)
        return make_metric("interstellar", m=self.m, a=self.a, rho=self.rho,
                           **kw)

    @classmethod
    def from_dict(cls, d, where="metric settings"):
        if "kind" in d:
            return cls(**d).validate()
        # structural sniffing, Interstellar schema first
        if {"m", "a", "rho"} <= set(d):
            return cls(kind="interstellar", **d).validate()
        if set(d) == {"rho"}:
            return cls(kind="ellis", rho=d["rho"]).validate()
        raise SettingsError(
            f"{where}: not a valid metric settings schema (need kind=, or "
            f"the Interstellar {{m,a,rho}} / Ellis {{rho}} schema)")

    @classmethod
    def from_toml(cls, path=None):
        if path is None:
            d = _default_toml("ellis_metric_settings.toml")
            return cls(kind="ellis", **d).validate()
        return cls.from_dict(_load_toml(path), where=str(path))


@dataclasses.dataclass(frozen=True)
class Settings:
    """All five categories from ONE file."""
    image: ImageSettings
    video: VideoSettings
    camera: CameraSettings
    simulation: SimulationSettings
    metric: MetricSettings


_SECTIONS = ("image", "video", "camera", "simulation", "metric")


def load_settings(path=None) -> Settings:
    """Parse an all-in-one settings TOML with sections ``[image] [video]
    [camera] [simulation] [metric]`` (any subset; missing ones take the
    defaults; unknown sections are an error)."""
    d = _load_toml(path) if path else {}
    unknown = set(d) - set(_SECTIONS)
    if unknown:
        raise SettingsError(
            f"{path}: unknown settings section(s) {sorted(unknown)}; "
            f"expected a subset of {list(_SECTIONS)}")

    def sec(name):
        return dict(d.get(name, {}))

    sim = sec("simulation")
    if "ray_integration_max_itarations" in sim:
        sim["ray_integration_max_iterations"] = sim.pop(
            "ray_integration_max_itarations")
    vid = VideoSettings(**sec("video"))
    if path and vid.filepath_to_camera_path \
            and not Path(vid.filepath_to_camera_path).is_absolute():
        rel = Path(path).parent / vid.filepath_to_camera_path
        if rel.exists():
            vid = dataclasses.replace(vid, filepath_to_camera_path=str(rel))
    metric = (MetricSettings.from_dict(sec("metric"), where=f"{path}[metric]")
              if "metric" in d else MetricSettings.from_toml(None))
    return Settings(
        image=ImageSettings(**sec("image")).validate(),
        video=vid.validate(),
        camera=CameraSettings(**sec("camera")).validate(),
        simulation=SimulationSettings(**sim).validate(),
        metric=metric,
    )
