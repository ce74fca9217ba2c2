"""Helpers of the port that belong to no layer: the native (C++) libraries."""
