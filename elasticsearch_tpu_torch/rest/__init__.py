"""The REST layer: the controller and the actions it routes to."""
