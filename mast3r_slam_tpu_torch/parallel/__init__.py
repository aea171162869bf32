"""Placement across devices. Only the backend-device rule is ported; the
mirror, data-parallel tracking, sharded BA and the mesh are ROADMAP.md
queue 1 item 7."""
