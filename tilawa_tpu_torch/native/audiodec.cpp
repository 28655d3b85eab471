// Native audio decoder: any container/codec -> float32 mono @ target_sr.
//
// TPU-native replacement for the reference's librosa/ffmpeg decode path
// (reference: shared/audio.py:8-18 load_audio -> librosa.load). The
// reference leans on librosa -> audioread -> ffmpeg for mp3/m4a corpus
// clips (benchmark/test_corpus/*.mp3, *.m4a); here the same system
// libraries (libavformat/libavcodec/libswresample) are driven directly
// from C++ with a minimal ctypes surface so the Python layer stays
// dependency-free.
//
// Build:  g++ -O2 -shared -fPIC -std=c++17 audiodec.cpp -o _audiodec.so \
//             -lavformat -lavcodec -lavutil -lswresample
//
// API (ctypes):
//   long long tilawa_decode_audio(const char* path, int target_sr,
//                                 float** out_samples, char* err, int errlen);
//     -> sample count (>=0) on success; negative on failure (err filled).
//   void tilawa_free_samples(float* p);

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

namespace {

struct Decoded {
    std::vector<float> samples;
};

void set_err(char* err, int errlen, const std::string& msg) {
    if (err && errlen > 0) {
        std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
    }
}

std::string av_errstr(int code) {
    char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
    av_strerror(code, buf, sizeof(buf));
    return std::string(buf);
}

// Convert one decoded frame through swresample, appending mono f32 samples.
int convert_frame(SwrContext* swr, const AVFrame* frame, int target_sr,
                  std::vector<float>& out) {
    // Upper bound on output samples for this frame (plus buffered carry).
    int64_t delay = swr_get_delay(swr, frame ? frame->sample_rate : target_sr);
    int64_t in_count = frame ? frame->nb_samples : 0;
    int max_out = static_cast<int>(
        av_rescale_rnd(delay + in_count,
                       target_sr,
                       frame ? frame->sample_rate : target_sr,
                       AV_ROUND_UP));
    if (max_out <= 0) max_out = 4096;

    size_t base = out.size();
    out.resize(base + static_cast<size_t>(max_out));
    uint8_t* out_planes[1] = {
        reinterpret_cast<uint8_t*>(out.data() + base)};

    int got = swr_convert(swr, out_planes, max_out,
                          frame ? const_cast<const uint8_t**>(
                                      frame->extended_data)
                                : nullptr,
                          frame ? frame->nb_samples : 0);
    if (got < 0) {
        out.resize(base);
        return got;
    }
    out.resize(base + static_cast<size_t>(got));
    return 0;
}

}  // namespace

extern "C" {

long long tilawa_decode_audio(const char* path, int target_sr,
                              float** out_samples, char* err, int errlen) {
    *out_samples = nullptr;
    av_log_set_level(AV_LOG_ERROR);

    AVFormatContext* fmt = nullptr;
    int rc = avformat_open_input(&fmt, path, nullptr, nullptr);
    if (rc < 0) {
        set_err(err, errlen, "open_input: " + av_errstr(rc));
        return -1;
    }
    rc = avformat_find_stream_info(fmt, nullptr);
    if (rc < 0) {
        set_err(err, errlen, "find_stream_info: " + av_errstr(rc));
        avformat_close_input(&fmt);
        return -2;
    }
    const AVCodec* codec = nullptr;
    int stream_idx =
        av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
    if (stream_idx < 0 || !codec) {
        set_err(err, errlen, "no audio stream");
        avformat_close_input(&fmt);
        return -3;
    }
    AVStream* stream = fmt->streams[stream_idx];

    AVCodecContext* ctx = avcodec_alloc_context3(codec);
    if (!ctx) {
        set_err(err, errlen, "alloc codec context failed");
        avformat_close_input(&fmt);
        return -4;
    }
    rc = avcodec_parameters_to_context(ctx, stream->codecpar);
    if (rc >= 0) rc = avcodec_open2(ctx, codec, nullptr);
    if (rc < 0) {
        set_err(err, errlen, "codec open: " + av_errstr(rc));
        avcodec_free_context(&ctx);
        avformat_close_input(&fmt);
        return -5;
    }
    if (ctx->ch_layout.nb_channels <= 0) {
        av_channel_layout_default(&ctx->ch_layout, 1);
    }

    SwrContext* swr = nullptr;
    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    rc = swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, target_sr,
                             &ctx->ch_layout, ctx->sample_fmt,
                             ctx->sample_rate, 0, nullptr);
    if (rc >= 0) rc = swr_init(swr);
    if (rc < 0) {
        set_err(err, errlen, "swr init: " + av_errstr(rc));
        if (swr) swr_free(&swr);
        avcodec_free_context(&ctx);
        avformat_close_input(&fmt);
        return -6;
    }

    Decoded dec;
    dec.samples.reserve(1 << 20);
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    bool failed = false;
    std::string fail_msg;

    auto drain_decoder = [&](bool flush) {
        if (flush) avcodec_send_packet(ctx, nullptr);
        while (true) {
            int r = avcodec_receive_frame(ctx, frame);
            if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
            if (r < 0) {
                failed = true;
                fail_msg = "receive_frame: " + av_errstr(r);
                break;
            }
            r = convert_frame(swr, frame, target_sr, dec.samples);
            av_frame_unref(frame);
            if (r < 0) {
                failed = true;
                fail_msg = "swr_convert: " + av_errstr(r);
                break;
            }
        }
    };

    while (!failed && av_read_frame(fmt, pkt) >= 0) {
        if (pkt->stream_index == stream_idx) {
            rc = avcodec_send_packet(ctx, pkt);
            // Tolerate corrupt packets (decoder resync) like ffmpeg CLI does.
            if (rc >= 0 || rc == AVERROR(EAGAIN) || rc == AVERROR_INVALIDDATA) {
                drain_decoder(false);
            }
        }
        av_packet_unref(pkt);
    }
    if (!failed) drain_decoder(true);          // flush decoder
    if (!failed) {
        // Flush resampler carry.
        int r = convert_frame(swr, nullptr, target_sr, dec.samples);
        if (r < 0) {
            failed = true;
            fail_msg = "swr flush: " + av_errstr(r);
        }
    }

    av_frame_free(&frame);
    av_packet_free(&pkt);
    swr_free(&swr);
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);

    if (failed) {
        set_err(err, errlen, fail_msg);
        return -7;
    }
    if (dec.samples.empty()) {
        set_err(err, errlen, "decoded zero samples");
        return -8;
    }

    float* buf = static_cast<float*>(
        std::malloc(dec.samples.size() * sizeof(float)));
    if (!buf) {
        set_err(err, errlen, "oom");
        return -9;
    }
    std::memcpy(buf, dec.samples.data(), dec.samples.size() * sizeof(float));
    *out_samples = buf;
    return static_cast<long long>(dec.samples.size());
}

void tilawa_free_samples(float* p) { std::free(p); }

}  // extern "C"
