"""Flat BVH buffer types shared by the packers, and the wide-BVH mega-table."""
