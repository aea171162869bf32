"""SLAM frontend: tracker, frames and keyframe store, system driver."""
