"""Stream runtime: window state machine, stream state and the frame step."""
