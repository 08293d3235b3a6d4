"""Seeding, image IO and camera lists."""
