"""Post-processing of sweep CSVs (heatmaps)."""
