"""Flat BVH buffer types shared by the packers."""
