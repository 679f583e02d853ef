"""One module per kind of entry point a cell drives, found by the cell's
"driver" name."""
