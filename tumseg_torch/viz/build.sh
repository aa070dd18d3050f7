#!/bin/sh
# Build the native ball renderer next to this script.
cd "$(dirname "$0")" && g++ -std=c++17 -O2 -shared -fPIC -o render_balls.so render_balls.cpp
