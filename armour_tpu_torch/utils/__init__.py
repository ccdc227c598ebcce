"""See the matching subpackage of armour_tpu for the reference."""
