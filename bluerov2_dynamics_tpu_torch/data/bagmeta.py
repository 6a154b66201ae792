"""rosbag2 ``metadata.yaml`` reader (stdlib, no PyYAML dependency).

Counterpart of ``bluerov2_dynamics_tpu/data/bagmeta.py``.  A recording's
``metadata.yaml`` records its topic names, ROS types, serialization format,
message counts and duration; this module parses it so that the ingestion
layer can check its configured topics and decoders against a recording
before decoding it (:func:`..bag2csv.validate_against_metadata`).

Parser scope: the indentation-structured subset rosbag2 actually writes
(nested maps, ``- `` item lists, scalar ints/strings, double-quoted
one-line strings with ``\\n`` escapes such as ``offered_qos_profiles``).
It is NOT a general YAML parser and does not try to be one.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple, Union

__all__ = [
    "TopicMeta",
    "BagMetadata",
    "parse_simple_yaml",
    "read_metadata",
]

_MAP_LINE = re.compile(r"^[A-Za-z_][\w]*:(\s|$)")


def _parse_value(s: str):
    if s == "":
        return None
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        return s[1:-1].replace("\\n", "\n").replace('\\"', '"')
    if s in ("true", "false"):
        return s == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def parse_simple_yaml(text: str):
    """Parse the rosbag2-metadata YAML subset into dicts/lists/scalars."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        stripped = raw.strip()
        if not stripped or stripped.startswith("#"):
            continue
        lines.append((len(raw) - len(raw.lstrip(" ")), stripped))
    if not lines:
        return None
    value, i = _parse_node(lines, 0)
    if i != len(lines):
        raise ValueError(f"unparsed trailing content at line {i}: {lines[i]}")
    return value


def _parse_node(lines, i):
    ind, s = lines[i]
    if s.startswith("- "):
        return _parse_list(lines, i, ind)
    if _MAP_LINE.match(s):
        return _parse_map(lines, i, ind)
    return _parse_value(s), i + 1


def _parse_map(lines, i, indent):
    out: Dict[str, object] = {}
    while i < len(lines):
        ind, s = lines[i]
        if ind != indent or s.startswith("- "):
            break
        if not _MAP_LINE.match(s):
            raise ValueError(f"expected 'key:' at line {i}: {s!r}")
        key, _, rest = s.partition(":")
        rest = rest.strip()
        if rest:
            out[key] = _parse_value(rest)
            i += 1
            continue
        i += 1
        if i < len(lines) and (
            lines[i][0] > indent
            or (lines[i][0] == indent and lines[i][1].startswith("- "))
        ):
            out[key], i = _parse_node(lines, i)
        else:
            out[key] = None
    return out, i


def _parse_list(lines, i, indent):
    out: list = []
    while i < len(lines):
        ind, s = lines[i]
        if ind != indent or not s.startswith("- "):
            break
        # unpack the item content as a virtual line two columns deeper;
        # following deeper lines belong to the same item's map
        lines[i] = (ind + 2, s[2:])
        item, i = _parse_node(lines, i)
        out.append(item)
    return out, i


@dataclass(frozen=True)
class TopicMeta:
    """One entry of ``topics_with_message_count``."""

    name: str
    type: str
    serialization_format: str
    message_count: int


@dataclass(frozen=True)
class BagMetadata:
    """Typed view of a rosbag2 ``metadata.yaml`` (version 5 layout)."""

    version: int
    storage_identifier: str
    duration_ns: int
    starting_time_ns: int
    message_count: int
    topics: Tuple[TopicMeta, ...]
    relative_file_paths: Tuple[str, ...]

    @property
    def duration_s(self) -> float:
        return self.duration_ns / 1e9

    def topic(self, name: str) -> TopicMeta:
        for t in self.topics:
            if t.name == name:
                return t
        raise KeyError(f"topic {name!r} not in metadata "
                       f"({len(self.topics)} topics)")

    def rate_hz(self, name: str) -> float:
        """Mean message rate of ``name`` over the WHOLE recording
        duration.  rosbag2 metadata has no per-topic start/end time, so
        a topic that starts late or stops early reports a lower mean
        than its live publishing rate — treat values near a threshold as
        a hint, not a verdict (``validate_against_metadata`` words its
        warning accordingly)."""
        return self.topic(name).message_count / max(self.duration_s, 1e-9)


def read_metadata(path: Union[str, Path]) -> BagMetadata:
    """Read ``metadata.yaml`` from a file path or a bag directory."""
    p = Path(path)
    if p.is_dir():
        p = p / "metadata.yaml"
    doc = parse_simple_yaml(p.read_text())
    if not isinstance(doc, dict) or "rosbag2_bagfile_information" not in doc:
        raise ValueError(f"{p} is not a rosbag2 metadata.yaml")
    info = doc["rosbag2_bagfile_information"]
    topics = tuple(
        TopicMeta(
            name=t["topic_metadata"]["name"],
            type=t["topic_metadata"]["type"],
            serialization_format=t["topic_metadata"]["serialization_format"],
            message_count=int(t["message_count"]),
        )
        for t in info.get("topics_with_message_count", [])
    )
    return BagMetadata(
        version=int(info.get("version", 0)),
        storage_identifier=str(info.get("storage_identifier", "")),
        duration_ns=int(info["duration"]["nanoseconds"]),
        starting_time_ns=int(
            info["starting_time"]["nanoseconds_since_epoch"]),
        message_count=int(info["message_count"]),
        topics=topics,
        relative_file_paths=tuple(info.get("relative_file_paths") or ()),
    )
