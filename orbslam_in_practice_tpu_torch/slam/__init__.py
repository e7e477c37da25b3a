"""SLAM: tracking, the map, local mapping, relocalisation and loop closing."""
