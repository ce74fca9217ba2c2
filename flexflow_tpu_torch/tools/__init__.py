"""Command-line tools of the port: offline strategy search and calibration."""
