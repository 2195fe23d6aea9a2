"""CLI helpers; everything but the --trace edition is the reference's."""
