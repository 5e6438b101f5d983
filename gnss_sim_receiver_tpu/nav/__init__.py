"""Navigation-message data structures and bit-level codecs (host-side).

The equivalent of the reference's system_parameters nav-message classes
(src/core/system_parameters/gps_navigation_message.cc etc.): bit-level
telemetry is 50 bps — host work, not device work (SURVEY.md section 7)."""
