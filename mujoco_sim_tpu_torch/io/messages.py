"""Message/service types mirroring the external mujoco_msgs package
(SURVEY.md §2.4; fields inferred from reference usage mj_ros.cpp:941-966,
1340-1412, 2096-2120).  JSON-serializable dataclasses."""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class ObjectType(enum.IntEnum):
    CUBE = 0
    SPHERE = 1
    CYLINDER = 2
    MESH = 3


@dataclasses.dataclass
class Inertial:
    m: float = 0.0
    com: tuple = (0.0, 0.0, 0.0)
    ixx: float = 0.0
    ixy: float = 0.0
    ixz: float = 0.0
    iyy: float = 0.0
    iyz: float = 0.0
    izz: float = 0.0


@dataclasses.dataclass
class ObjectInfo:
    name: str = ""
    type: int = int(ObjectType.CUBE)
    movable: bool = True
    size: tuple = (0.1, 0.1, 0.1)
    rgba: tuple = (0.5, 0.5, 0.5, 1.0)
    mesh: str = ""              # path to .xml scene or .stl
    inertial: Optional[Inertial] = None

    def to_dict(self):
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        ine = d.pop("inertial", None)
        obj = cls(**{k: v for k, v in d.items()
                     if k in {f.name for f in dataclasses.fields(cls)}})
        if ine:
            obj.inertial = Inertial(**ine)
        return obj


@dataclasses.dataclass
class Pose:
    position: tuple = (0.0, 0.0, 0.0)
    orientation: tuple = (1.0, 0.0, 0.0, 0.0)  # w x y z


@dataclasses.dataclass
class Twist:
    linear: tuple = (0.0, 0.0, 0.0)
    angular: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class ObjectStatus:
    info: ObjectInfo = dataclasses.field(default_factory=ObjectInfo)
    pose: Pose = dataclasses.field(default_factory=Pose)
    velocity: Twist = dataclasses.field(default_factory=Twist)


@dataclasses.dataclass
class ObjectState:
    name: str = ""
    pose: Pose = dataclasses.field(default_factory=Pose)
    velocity: Twist = dataclasses.field(default_factory=Twist)
